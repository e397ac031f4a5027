"""Architecture and input-shape registry of the port.

Each ported architecture has a module ``repro_torch/configs/<id>.py``
defining ``CONFIG = ArchConfig(...)`` with the published
hyper-parameters, the same values as the JAX package's twin.
``ArchConfig.build`` instantiates the model; ``reduced()`` yields the
smoke-test variant (2 layers, d_model <= 128, fp32) of the same family.
Dtypes are torch dtypes; bf16 is the default, as in the JAX package.

Ported so far: the dense family (qwen2-0.5b, qwen2.5-3b, qwen2.5-32b,
codeqwen1.5-7b), the ssm family (xlstm-1.3b), the moe family
(granite-moe-3b-a800m; deepseek-v2-236b, with MLA), the audio family
(whisper-large-v3), the hybrid family (hymba-1.5b) and the vlm family
(qwen2-vl-7b).  ViT-B/32 has a config of its own
(``configs/vit_b32.py``: a ``ViTConfig``, built by its ``build``), which
``load_arch("vit-b32")`` returns; ``load_arch`` of a name with no config
raises.

``input_specs`` gives every model input of an (arch × shape) pair, as
``meta`` tensors (the reference's ``ShapeDtypeStruct`` stand-ins) or as
real ones.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""                 # citation
    # dense/attention options
    qkv_bias: bool = False
    rope_base: float = 1_000_000.0
    tie_embeddings: bool = False
    head_dim: Optional[int] = None
    # moe options
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    shared_d_ff: Optional[int] = None
    moe_capacity_factor: float = 1.25
    # mla options (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # ssm / hybrid options
    ssm_state: int = 16
    mlstm_chunk: int = 256
    hybrid_window: int = 2048        # hymba SWA on the attention branch
    # vlm options
    mrope_sections: Optional[Tuple[int, int, int]] = None
    vision_tokens: int = 1024        # stub patch embeddings per sample
    # audio options
    enc_frames: int = 1500
    # long-context policy
    sliding_window_long: Optional[int] = 4096  # None => skip long_500k
    # PEFT / numerics
    lora_rank: int = 16
    dtype: Any = torch.bfloat16
    remat: bool = True

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims, fp32 (the JAX
        package's ``reduced()``, field for field)."""
        return replace(
            self,
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            shared_d_ff=min(self.shared_d_ff, 64) if self.shared_d_ff else None,
            moe_capacity_factor=8.0,
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_dim=16,
            qk_rope_dim=8,
            v_head_dim=16,
            head_dim=None,
            ssm_state=8,
            mlstm_chunk=16,
            hybrid_window=16,
            vision_tokens=8,
            enc_frames=16,
            mrope_sections=(4, 6, 6) if self.mrope_sections else None,
            lora_rank=4,
            dtype=torch.float32,
            remat=False,
        )

    @property
    def supports_long(self) -> bool:
        if self.family in ("ssm", "hybrid"):
            return True
        if self.family == "audio":
            return False  # a 500k decoder context means nothing for whisper
        return self.sliding_window_long is not None

    def window_for_shape(self, shape: ShapeSpec) -> Optional[int]:
        if shape.name == "long_500k" and self.family not in ("ssm",):
            return self.sliding_window_long
        return None

    def build(self, shape: Optional[ShapeSpec] = None, *, device="cuda"):
        from repro_torch.models.builders import build_model
        return build_model(self, shape, device=device)

    def lora_targets(self) -> Tuple[str, ...]:
        """Module-path patterns of the matmuls that carry LoRA adapters
        (each adapter leaf is ``<pattern>/{a,b,alpha}``)."""
        return lora_targets_for(self)

    def check_lora_targets(self, leaf_paths) -> None:
        """Every declared target must appear among ``leaf_paths`` and no
        adapter may live outside them; raises ``ValueError``."""
        check_lora_targets(self.lora_targets(), leaf_paths,
                           context=f"{self.name} ({self.family})")


_FAMILY_LORA_TARGETS: Dict[str, Tuple[str, ...]] = {
    "dense":  ("mixer/wq", "mixer/wo", "ffn/down"),
    "vlm":    ("mixer/wq", "mixer/wo", "ffn/down"),
    "ssm":    ("mlstm/up", "mlstm/down", "slstm/wx", "slstm/ffn_down"),
    "hybrid": ("mixer/attn/wq", "mixer/attn/wo",
               "mixer/mamba/in_proj", "mixer/mamba/out_proj", "ffn/down"),
    "audio":  ("encoder/attn/wq", "encoder/attn/wo", "encoder/mlp/down",
               "decoder/self_attn/wq", "decoder/self_attn/wo",
               "decoder/cross_attn/wq", "decoder/cross_attn/wo",
               "decoder/mlp/down"),
    "vit":    ("attn/wq", "attn/wo", "mlp/down"),
}


def lora_targets_for(cfg) -> Tuple[str, ...]:
    """Family targeting rules for an :class:`ArchConfig`."""
    family = cfg.family
    if family == "moe":
        targets = ["mixer/wq_a" if getattr(cfg, "use_mla", False)
                   else "mixer/wq", "mixer/wo"]
        if getattr(cfg, "n_shared_experts", 0) > 0:
            targets.append("ffn/shared/down")
        return tuple(targets)
    return _FAMILY_LORA_TARGETS[family]


def check_lora_targets(targets: Tuple[str, ...], leaf_paths,
                       context: str = "") -> None:
    """Every target pattern must match >= 1 adapter leaf and every leaf
    must belong to a declared target (leaves are ``.../{a,b,alpha}``)."""
    where = f" [{context}]" if context else ""
    modules = set()
    for path in leaf_paths:
        mod = path.rsplit("/", 1)[0]
        if not any(mod == t or mod.endswith("/" + t) for t in targets):
            raise ValueError(
                f"LoRA adapter at {path!r} is outside the declared "
                f"targets {targets}{where}")
        modules.add(mod)
    for t in targets:
        if not any(m == t or m.endswith("/" + t) for m in modules):
            raise ValueError(
                f"declared LoRA target {t!r} has no adapter in the "
                f"manifest (modules: {sorted(modules)}){where}")


def load_arch(name: str) -> ArchConfig:
    """The config of a ported architecture; raises ``ValueError`` for a
    name the port has no config for yet."""
    mod_name = name.replace("-", "_").replace(".", "_")
    try:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    except ModuleNotFoundError as e:
        if e.name != f"repro_torch.configs.{mod_name}":
            raise
        raise ValueError(f"architecture {name!r} is not ported yet (ported: "
                         f"{PORTED_ARCHS})") from None
    return mod.CONFIG


# the assigned architectures, in the reference's order
ARCH_IDS = [
    "xlstm-1.3b",
    "qwen2.5-3b",
    "whisper-large-v3",
    "hymba-1.5b",
    "qwen2-0.5b",
    "deepseek-v2-236b",
    "qwen2.5-32b",
    "qwen2-vl-7b",
    "granite-moe-3b-a800m",
    "codeqwen1.5-7b",
]

PORTED_ARCHS = ("qwen2-0.5b", "xlstm-1.3b", "granite-moe-3b-a800m",
                "whisper-large-v3", "hymba-1.5b", "qwen2-vl-7b",
                "deepseek-v2-236b", "qwen2.5-3b", "qwen2.5-32b",
                "codeqwen1.5-7b")


# Reduced model zoo for federated rounds: one representative arch per
# family key.  ``fed.testbed.make_zoo_backbones`` builds an
# ``ArchBackbone`` per entry (vit_b32 is a bespoke ``ViTConfig`` and is
# special-cased there); a mixed round draws clients across families.
ZOO_FAMILIES: Dict[str, str] = {
    "lm": "qwen2-0.5b",             # dense decoder LM
    "encdec": "whisper-large-v3",   # audio encoder-decoder
    "vit": "vit_b32",               # vision transformer
    "ssm": "xlstm-1.3b",            # recurrent xLSTM stack
    "moe": "granite-moe-3b-a800m",  # sparse mixture-of-experts
}


def input_specs(cfg: ArchConfig, shape: ShapeSpec, *, concrete: bool = False,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None,
                device="cuda") -> Dict[str, Any]:
    """Model inputs of ``shape`` for ``cfg``: ``meta`` tensors (the
    reference's ``ShapeDtypeStruct`` stand-ins) by default; with
    ``concrete=True`` real ones on ``device`` -- int32 zeros, and 0.01 in
    the config's dtype for float inputs, as the reference fills them."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    fdt, i32 = cfg.dtype, torch.int32

    def mk(shp, dt):
        if not concrete:
            return torch.empty(shp, dtype=dt, device="meta")
        if dt == i32:
            return torch.zeros(shp, dtype=dt, device=device)
        return torch.ones(shp, dtype=dt, device=device) * 0.01

    if shape.kind == "decode":
        batch = {"tokens": mk((b, 1), i32)}
    elif cfg.family == "audio":
        batch = {"audio_embeds": mk((b, cfg.enc_frames, cfg.d_model), fdt),
                 "tokens": mk((b, s), i32), "labels": mk((b, s), i32)}
    elif cfg.family == "vlm":
        n_img = min(cfg.vision_tokens, max(s // 4, 1))
        n_txt = s - n_img
        batch = {"tokens": mk((b, n_txt), i32), "labels": mk((b, n_txt), i32),
                 "extra_embeds": mk((b, n_img, cfg.d_model), fdt),
                 "positions": mk((b, s, 3), i32)}
    else:
        batch = {"tokens": mk((b, s), i32), "labels": mk((b, s), i32)}
    if shape.kind == "prefill":
        batch.pop("labels", None)
    return batch
