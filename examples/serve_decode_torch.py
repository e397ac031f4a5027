"""Multi-tenant serving demo on the PyTorch/CUDA port: ONE backbone +
ONE unified task vector + T cheap modulators, decoding a mixed-task
batch.

An actual federated round feeds serving: per-task clients fine-tune
LoRA on distinct Markov "languages" (same rig as fed_finetune_lm_torch),
the MaTU server aggregates, and ``serving_downlink`` hands the round's
unified vector + packed modulators straight to a ``ModulatorStore``.
Requests then carry task ids as DATA: every task mix routes to a LoRA
tree of the same leaves, shapes and dtypes, so one decode path serves
them all — dense-routed adapters from the store's LRU, or the fused
path where packed mask bits are modulated inside the LoRA matmul kernel
(``ops.modulated_matmul``).

It runs on a CUDA device (``main(device="cpu")`` runs it on the CPU,
each kernel through its plain PyTorch version):

    PYTHONPATH=src python examples/serve_decode_torch.py [--quick]
"""

import argparse
import time

import torch

from repro_torch.common.tree import (TaskVectorSpace, tree_leaves_with_path,
                                     tree_map)
from repro_torch.configs.base import SHAPES, load_arch
from repro_torch.core.client import ClientUpload
from repro_torch.core.server import MaTUServer, MaTUServerConfig
from repro_torch.core.unify import unify_with_modulators
from repro_torch.optim import adamw
from repro_torch.serve import GenerationConfig, ModulatorStore, MultiTenantDecoder
from repro_torch.train.trainer import make_train_step

from fed_finetune_lm_torch import make_task_sampler


def federated_round(model, params, lora0, space, samplers, *,
                    local_steps, batch, seq, vocab):
    """One synchronous round, one single-task client per task, through
    the real local-trainer + MaTU server pipeline.  Returns the server
    and the round's uploads."""
    train_step, opt = make_train_step(model, adamw(5e-3))
    uploads = []
    for t in sorted(samplers):
        lora = lora0
        state = opt.init(lora)
        for _ in range(local_steps):
            lora, state, m = train_step(params, lora, state,
                                        samplers[t](batch, seq))
        delta = tree_map(torch.sub, lora, lora0)
        unified, masks, lams = unify_with_modulators(
            space.flatten(delta)[None])
        uploads.append(ClientUpload(
            t, [t], unified, masks, lams, [batch * seq],
            fingerprint=space.fingerprint))
    server = MaTUServer(MaTUServerConfig(n_tasks=len(samplers)),
                        device=model.device)
    server.round(uploads)
    return server, uploads


def timed_batches(decoder, prompts, task_ids, *, reps):
    decoder.generate(prompts, task_ids)                 # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = decoder.generate(prompts, task_ids)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    dt = time.perf_counter() - t0
    return out, reps * len(task_ids) / dt


def route_signature(decoder, task_ids):
    """(leaf path, shape, dtype) of every leaf of the routed tree: equal
    for two mixes when one decode path serves both."""
    return [("/".join(p), tuple(x.shape), x.dtype)
            for p, x in tree_leaves_with_path(decoder.route(task_ids))]


def main(argv=None, *, cfg=None, device="cuda"):
    """Runs the example; ``cfg`` (default the reduced qwen2-0.5b) is the
    model's config.  Returns a dict: the storage report (``report``),
    the ``prompts``, the ``mixes`` and each mix's dense-routed tokens
    (``mix_tokens``), the timed dense and fused tokens and req/s, whether
    every mix routes to one leaf signature on both decoders
    (``one_route``), the ``dense`` and ``fused`` decoders, the ``store``,
    and the round's ``server`` and ``uploads``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI-smoke sizes (fewer local steps / reps)")
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=None)
    args = ap.parse_args(argv)
    local_steps = args.local_steps or (2 if args.quick else 6)
    reps = 2 if args.quick else 8

    label = "reduced qwen2" if cfg is None else cfg.name
    cfg = cfg or load_arch("qwen2-0.5b").reduced()
    model = cfg.build(SHAPES["decode_32k"], device=device)
    params = model.init(0)
    lora0 = model.lora_init(1)
    dev = model.device
    space = TaskVectorSpace.from_tree(lora0)
    print(f"backbone: {label}, LoRA d = {space.d}, "
          f"layout {space.fingerprint}")

    samplers = {t: make_task_sampler(t, cfg.vocab, device=dev)
                for t in range(args.tasks)}
    server, uploads = federated_round(model, params, lora0, space, samplers,
                                      local_steps=local_steps, batch=4,
                                      seq=32, vocab=cfg.vocab)

    # -- the serving handoff: one downlink makes the round resident ----
    store = ModulatorStore(space, lora0, capacity=args.tasks, device=dev)
    store.ingest(server.serving_downlink(fingerprint=space.fingerprint))
    rep = store.storage_report()
    print(f"store: {rep['tasks']} tasks resident in "
          f"{rep['resident_bytes']/2**20:.2f} MiB vs "
          f"{rep['checkpoint_bytes']/2**20:.2f} MiB of per-task "
          f"checkpoints ({rep['ratio']:.1f}x smaller)")

    # -- mixed-task traffic: task ids are data, one decode path serves all
    gen_cfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    b = args.tasks
    prompts = torch.randint(1, cfg.vocab, (b, 16),
                            generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32).to(dev)
    mixes = [list(range(args.tasks)),
             list(range(args.tasks))[::-1],
             [0] * b]
    dense = MultiTenantDecoder(model, params, store, cfg=gen_cfg, device=dev)
    fused = MultiTenantDecoder(model, params, store, fused=True,
                               cfg=gen_cfg, device=dev)

    mix_tokens = []
    for mix in mixes:
        out = dense.generate(prompts, mix)
        mix_tokens.append(out)
        print(f"  mix {mix}: first tokens "
              f"{[int(x) for x in out[:, prompts.shape[1]]]}")
    # eager PyTorch compiles no decode program; what the JAX example's
    # one-program assertion stands for is that every mix routes to a
    # tree of the same leaves, shapes and dtypes
    one_route = {}
    for name, dec in (("dense", dense), ("fused", fused)):
        sigs = [route_signature(dec, mix) for mix in mixes]
        one_route[name] = all(sig == sigs[0] for sig in sigs[1:])
    assert all(one_route.values()), "routed tree changed across mixes"

    mix = mixes[0]
    out_d, rps_d = timed_batches(dense, prompts, mix, reps=reps)
    out_f, rps_f = timed_batches(fused, prompts, mix, reps=reps)
    same = bool(torch.equal(out_d, out_f))
    print(f"dense-routed: {rps_d:.1f} req/s   fused: {rps_f:.1f} req/s   "
          f"tokens identical: {same}")
    print(f"one routed tree across mixes: dense={one_route['dense']} "
          f"fused={one_route['fused']}  "
          f"LRU hits/misses: {store.hits}/{store.misses}")
    assert same, "fused decode diverged from dense-routed"
    return {"report": rep, "prompts": prompts, "mixes": mixes,
            "mix_tokens": mix_tokens, "dense_tokens": out_d,
            "fused_tokens": out_f, "dense_rps": rps_d, "fused_rps": rps_f,
            "one_route": one_route, "dense": dense, "fused": fused,
            "store": store, "server": server, "uploads": uploads}


if __name__ == "__main__":
    main()
