"""Assemble models from ``ArchConfig`` (one builder per family).

``build_model`` returns an :class:`ArchModel` with the uniform interface
the serving and training paths rely on: ``init`` / ``lora_init``,
``axes`` / ``lora_axes`` / ``cache_axes``, ``forward``, ``loss``,
``init_cache``, ``prefill_step`` and ``decode_fn``.  Ported so far: the
dense family (qwen2-0.5b, the qwen2.5 configs, codeqwen1.5-7b), the vlm
family (qwen2-vl-7b: the dense stack with M-RoPE, whose prefill batch
also carries ``"extra_embeds"`` and (B, S, 3) ``"positions"``), the ssm
family (xlstm-1.3b, alternating mLSTM / sLSTM blocks), the moe family
with attention (granite-moe-3b-a800m) or with Multi-head Latent
Attention (deepseek-v2-236b: an
:class:`~repro_torch.nn.mla.MLAttention` mixer, routed and shared
experts), the hybrid family (hymba-1.5b: attention with a
sliding window beside a Mamba branch, a
:class:`~repro_torch.models.blocks.HybridMixer`) and the audio family
(whisper-large-v3, an :class:`~repro_torch.models.encdec.EncDecLM`, whose
prefill batch also carries ``"audio_embeds"``); the other families
raise.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.common.device import DeviceLike
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.blocks import Block, HybridMixer, SSMBlockAdapter
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import LM
from repro_torch.nn.attention import Attention
from repro_torch.nn.mla import MLAttention
from repro_torch.nn.mlp import SwiGLU
from repro_torch.nn.moe import MoE
from repro_torch.nn.ssm import Mamba, MLSTMBlock, SLSTMBlock


class ArchModel:
    """Uniform facade over an LM for one (config, shape) pair."""

    def __init__(self, cfg: ArchConfig, model, kind: str):
        self.cfg = cfg
        self.model = model
        self.kind = kind  # "lm" | "encdec"

    @property
    def device(self):
        return self.model.device

    def init(self, generator=0, *, device=None):
        return self.model.init(generator, device=device)

    def lora_init(self, generator=1, *, device=None):
        return self.model.lora_init(generator, self.cfg.lora_rank,
                                    device=device)

    def axes(self):
        return self.model.axes()

    def lora_axes(self):
        return self.model.lora_axes()

    def cache_axes(self):
        return self.model.cache_axes()

    def forward(self, params, tokens, *, lora=None, mode=None,
                audio_embeds=None, extra_embeds=None, positions=None):
        """Full-sequence logits; an encdec model also takes the frame
        embeddings ``audio_embeds`` (B, T_enc, d), a vlm the prepended
        ``extra_embeds`` (B, S_img, d) and (B, S, 3) ``positions``."""
        if self.kind == "encdec":
            return self.model.forward(params, tokens, audio_embeds,
                                      lora=lora, mode=mode)
        return self.model.forward(params, tokens, lora=lora, mode=mode,
                                  extra_embeds=extra_embeds,
                                  positions=positions)

    def loss(self, params, lora, batch):
        """Next-token CE of ``batch`` (the train step's body)."""
        return self.model.loss(params, lora, batch)

    def init_cache(self, batch: int, max_len: int, dtype=None):
        return self.model.init_cache(batch, max_len, dtype)

    def prefill_step(self, params, lora, batch, cache, *, mode=None):
        return self.model.prefill(params, lora, batch, cache, mode=mode)

    def decode_fn(self, params, lora, batch, cache, pos: int, *, mode=None):
        return self.model.decode_step(params, lora, batch["tokens"], cache,
                                      pos, mode=mode)


def _attention(cfg: ArchConfig, window: Optional[int]) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, rope=True,
                     rope_base=cfg.rope_base,
                     mrope_sections=cfg.mrope_sections, window=window,
                     dtype=cfg.dtype)


def build_model(cfg: ArchConfig, shape: Optional[ShapeSpec] = None, *,
                device: DeviceLike = "cuda") -> ArchModel:
    """The model of ``cfg`` on ``device`` (default CUDA; raises without a
    card).  A ``shape`` of the long-context kind gives the attention its
    sliding window, as in the JAX package."""
    window = cfg.window_for_shape(shape) if shape is not None else None
    dt = cfg.dtype
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.family == "moe" and cfg.use_mla:
            mixer = MLAttention(
                cfg.d_model, cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
                kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
                qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                rope_base=cfg.rope_base, window=window, dtype=dt)
        else:
            mixer = _attention(cfg, window)
        ffn = (SwiGLU(cfg.d_model, cfg.d_ff, dtype=dt)
               if cfg.family != "moe" else
               MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                   n_shared=cfg.n_shared_experts, shared_d_ff=cfg.shared_d_ff,
                   capacity_factor=cfg.moe_capacity_factor, dtype=dt))
        block = Block(cfg.d_model, mixer, ffn, dtype=dt)
        lm = LM(vocab=cfg.vocab, d_model=cfg.d_model, n_units=cfg.n_layers,
                unit_blocks=[("blk", block)],
                tie_embeddings=cfg.tie_embeddings,
                mrope=cfg.mrope_sections is not None, remat=cfg.remat,
                dtype=dt, device=device)
        return ArchModel(cfg, lm, "lm")
    if cfg.family == "ssm":             # xLSTM: alternating mLSTM/sLSTM pairs
        if cfg.n_layers % 2:
            raise ValueError(f"ssm family needs an even n_layers, got "
                             f"{cfg.n_layers}")
        mlstm = SSMBlockAdapter(MLSTMBlock(cfg.d_model, cfg.n_heads,
                                           chunk=cfg.mlstm_chunk, dtype=dt))
        slstm = SSMBlockAdapter(SLSTMBlock(cfg.d_model, cfg.n_heads,
                                           dtype=dt))
        lm = LM(vocab=cfg.vocab, d_model=cfg.d_model,
                n_units=cfg.n_layers // 2,
                unit_blocks=[("mlstm", mlstm), ("slstm", slstm)],
                tie_embeddings=cfg.tie_embeddings, remat=cfg.remat, dtype=dt,
                device=device)
        return ArchModel(cfg, lm, "lm")
    if cfg.family == "hybrid":          # hymba: parallel attention ‖ Mamba
        attn = _attention(cfg, window if window is not None
                          else cfg.hybrid_window)
        mamba = Mamba(cfg.d_model, d_state=cfg.ssm_state, dtype=dt)
        mixer = HybridMixer(cfg.d_model, attn, mamba, dtype=dt)
        block = Block(cfg.d_model, mixer, SwiGLU(cfg.d_model, cfg.d_ff,
                                                 dtype=dt), dtype=dt)
        lm = LM(vocab=cfg.vocab, d_model=cfg.d_model, n_units=cfg.n_layers,
                unit_blocks=[("blk", block)],
                tie_embeddings=cfg.tie_embeddings, remat=cfg.remat, dtype=dt,
                device=device)
        return ArchModel(cfg, lm, "lm")
    if cfg.family == "audio":           # whisper: encoder-decoder
        max_dec = max(448, shape.seq_len if shape is not None else 448)
        model = EncDecLM(vocab=cfg.vocab, d_model=cfg.d_model,
                         n_enc_layers=cfg.n_layers, n_dec_layers=cfg.n_layers,
                         n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                         max_dec_len=max_dec, enc_frames=cfg.enc_frames,
                         remat=cfg.remat, dtype=dt, device=device)
        return ArchModel(cfg, model, "encdec")
    raise ValueError(f"family {cfg.family!r} is not ported yet (ported: "
                     f"dense, vlm, ssm, moe, hybrid, audio)")
