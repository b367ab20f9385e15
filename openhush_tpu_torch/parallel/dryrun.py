"""The multi-device dry run: the port of __graft_entry__.py's
`_mesh_pass` and `dryrun_multichip`, on ranks of a torch.distributed world.

    python -m openhush_tpu_torch.parallel.dryrun N [--device cpu] [--backend gloo]

spawns N ranks (parallel/world.py: NCCL with a card a rank; `--backend
gloo` runs them all on fewer cards, `--device cpu` on the CPU) and runs,
on the main mesh ((N/2) x 2 for an even N, N x 1 otherwise, the
reference's rule) with the reference's tiny-but-sharded config:

- a train step (dp gradients, tp partials);
- an encode (the flash kernel on each rank's batch rows and heads), the
  cross-KV and a prefill;
- a greedy continuous-batching step, a speculative one (a 1-layer draft,
  replicated over `model`) and a beam-group one (G = n_data, K = 3, the
  groups over `data`);

then the reduced pass (train, encode and prefill, greedy) on the 2- and
4-rank sub-meshes that divide N. Every rank of the world takes part in
making each mesh; the ranks outside a sub-mesh wait. Last, rank 0 runs each
pass again on a mesh of one rank, on the same weights and inputs: the
parent holds the sharded outputs against it (losses and logits within
ATOL, tokens equal) and the model ranks of every data rank against each
other (the same tokens: the lockstep a collective needs), and prints the
reference's report lines. Any failure raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.whisper import decoding, model as whisper
from openhush_tpu_torch.models.whisper import weights
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.parallel import sharding as sh
from openhush_tpu_torch.parallel import world
from openhush_tpu_torch.runtime import batcher, beam_batcher
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.training import train

# Sharded against one rank: the CPU tests' tolerance (fp32 sums in another
# order across the reduce).
ATOL = 2e-4


def dryrun_cfg() -> WhisperConfig:
    """The reference's dry-run config (__graft_entry__.py:_dryrun_cfg:
    heads divisible by the model axis, short contexts) at twice its width,
    d 256: its 4 heads are then 64 wide, as every Whisper's are and as the
    flash kernel (K2) takes them; the reference's 32-wide heads run only
    its dense CPU fallback."""
    return WhisperConfig(
        name="dryrun", n_mels=80, n_audio_ctx=64,
        n_audio_state=256, n_audio_head=4, n_audio_layer=2,
        n_text_state=256, n_text_head=4, n_text_layer=2,
        n_vocab=51865, n_text_ctx=32, n_langs=99)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def mesh_pass(mesh: sh.Mesh, n_data: int, *, full: bool
              ) -> tuple[list[str], dict]:
    """One dry-run pass on this rank of `mesh`, at the sizes of a mesh with
    `n_data` data ranks (B = 2·n_data rows, G = n_data beam groups; a mesh
    of one rank given the sharded mesh's n_data is its reference). Returns
    the stages that ran and this rank's outputs as numpy: the loss, its
    rows' prefill logits, its slots' and groups' tokens. full=False runs
    the reduced train + encode/prefill + greedy pass."""
    cfg = dryrun_cfg()
    dev = mesh.device
    done: list[str] = []
    out: dict = {}

    B, S = 2 * n_data, 8
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((B, cfg.n_mels, cfg.n_audio_ctx * 2)
                              ).astype(np.float32)
    tokens = rng.integers(0, 1000, (B, S))
    targets = rng.integers(0, 1000, (B, S))
    rows = sh.data_sharding(mesh, B)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)

    optimizer = train.make_optimizer()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = sh.shard_params(
        weights.init_params(cfg, gen, torch.float32, dev), mesh)
    opt_state = optimizer.init(params)

    # --- training step (dp gradients + tp partials) ---
    params, opt_state, loss = train.train_step(
        cfg, optimizer, params, opt_state, put(mel), put(tokens),
        put(targets))
    out["loss"] = float(loss)
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"non-finite loss {out['loss']}")
    done.append(f"train(loss={out['loss']:.4f})")

    with torch.no_grad():
        # --- sharded encode (the flash kernel on the rank's rows and
        # heads) + prefill ---
        feats = whisper.encode(cfg, params, put(mel))
        cross_kv = whisper.compute_cross_kv(cfg, params, feats)
        cache = whisper.init_kv_cache(cfg, B, device=dev)
        cache = whisper.KVCache(*(
            c[sh.cache_spec(mesh, B, cfg.n_text_state)].contiguous()
            for c in (cache.k, cache.v)))
        logits, _ = whisper.decode(cfg, params, put(tokens), 0, cache,
                                   cross_kv)
        out["logits"] = _host(logits[..., :cfg.n_vocab])
        if not np.isfinite(out["logits"]).all():
            raise AssertionError("non-finite prefill logits")
        done.append("sharded-flash-encode+prefill")

        tok = WhisperTokenizer(cfg.n_langs)
        xkv_q = whisper.compute_cross_kv_quant(cfg, params, feats)
        prompt = tok.sot_sequence("en", "transcribe", timestamps=False)
        suppress = torch.from_numpy(decoding.build_suppress_mask(
            tok, cfg, decoding.DecodingOptions())).to(dev)

        def admit_slots(state, **draft):
            # Slots 0 and 1, each on the data rank that holds it, with its
            # own window of the batch.
            for slot in range(min(2, B)):
                local = sh.local_slot(mesh, slot, B)
                if local is not None:
                    batcher.admit(cfg, params, state, local, xkv_q, prompt,
                                  False, prompt_len=len(prompt), row=local,
                                  **draft)
            return state

        # --- GREEDY continuous-batching step ---
        state = sh.shard_slot_state(batcher.init_state(
            cfg, B, dtype=torch.float32, max_len=cfg.n_text_ctx,
            audio_ctx=cfg.n_audio_ctx, device=dev), params, B)
        state = batcher.step(cfg, params, admit_slots(state), suppress,
                             inner_steps=2)
        out["greedy"] = _host(state.tokens)
        out["greedy_length"] = _host(state.length)
        done.append("greedy-batcher-step")

        if full:
            # --- SPECULATIVE serving step (the draft replicated) ---
            draft_cfg = dataclasses.replace(cfg, name="dryrun-draft",
                                            n_text_layer=1)
            draft_params = weights.init_params(
                draft_cfg, torch.Generator(device=dev).manual_seed(9),
                torch.float32, dev)
            sstate = sh.shard_slot_state(batcher.init_state(
                cfg, B, dtype=torch.float32, max_len=cfg.n_text_ctx,
                audio_ctx=cfg.n_audio_ctx, draft_cfg=draft_cfg, device=dev),
                params, B)
            dxkv_q = whisper.compute_cross_kv_quant(draft_cfg, draft_params,
                                                    feats)
            sstate = admit_slots(sstate, draft_cfg=draft_cfg,
                                 draft_params=draft_params, draft_xkv=dxkv_q)
            sstate = batcher.spec_step(cfg, params, draft_cfg, draft_params,
                                       sstate, suppress, k_spec=3, n_iters=1,
                                       room_cap=cfg.n_text_ctx - 1)
            out["spec"] = _host(sstate.tokens)
            out["spec_length"] = _host(sstate.length)
            done.append("spec-batcher-step")

            # --- BEAM-GROUP serving step (groups over 'data' at group
            # boundaries): group g decodes window g·B/G, local row 0 of
            # its data rank ---
            G, K = n_data, 3
            bstate = sh.shard_beam_state(beam_batcher.init_state(
                cfg, G, K, dtype=torch.float32, max_len=cfg.n_text_ctx,
                audio_ctx=cfg.n_audio_ctx, device=dev), params, G, K)
            for g in range(min(2, G)):
                local = sh.local_slot(mesh, g, G)
                if local is not None:
                    beam_batcher.admit(
                        cfg, params, bstate, local, xkv_q, prompt, False,
                        prompt_len=len(prompt), max_new=8,
                        row=local * (B // G))
            bstate = beam_batcher.step(cfg, params, bstate, suppress,
                                       inner_steps=2)
            out["beam"] = _host(bstate.tokens)
            out["beam_lp"] = _host(bstate.alive_lp)
            out["beam_step"] = _host(bstate.step)
            done.append(f"beam-batcher-step(G={G},K={K})")
    return done, out


def _shapes(n_devices: int) -> list[tuple[int, int, bool]]:
    """(ranks, model axis, full) of each pass: the main mesh, then the 2-
    and 4-rank sub-meshes that divide n_devices."""
    shapes = [(n_devices, 2 if n_devices % 2 == 0 else 1, True)]
    for sub in (2, 4):
        if sub < n_devices and n_devices % sub == 0:
            shapes.append((sub, 2 if sub % 2 == 0 else 1, False))
    return shapes


def _rank(n_devices: int, device: str) -> dict:
    """A rank's share of the dry run: its coordinate, stages and outputs on
    every mesh it is in, and on rank 0 the one-rank references."""
    passes = []
    for n, n_model, full in _shapes(n_devices):
        mesh = sh.create_mesh(n_model, device, ranks=range(n))
        if mesh.coordinate is None:
            passes.append(None)
            continue
        stages, out = mesh_pass(mesh, mesh.n_data, full=full)
        passes.append({"coordinate": mesh.coordinate, "stages": stages,
                       "outputs": out})
    one = sh.create_mesh(1, device, ranks=[0])
    refs = [mesh_pass(one, n // n_model, full=full)[1]
            if dist.get_rank() == 0 else None
            for n, n_model, full in _shapes(n_devices)]
    return {"passes": passes, "references": refs}


def _assemble(passes: list, n_model: int) -> dict:
    """The world's outputs of one mesh, data ranks in order (model rank
    0's), after checking that the model ranks of each data rank agree."""
    by_coord = {p["coordinate"]: p["outputs"] for p in passes if p}
    n_data = len(by_coord) // n_model
    for (d, m), o in by_coord.items():
        for key in ("greedy", "spec", "beam"):
            if key in o and not np.array_equal(o[key], by_coord[d, 0][key]):
                raise AssertionError(f"model rank {m} of data rank {d} left "
                                     f"lockstep: its {key} tokens differ")
    rank0 = [by_coord[d, 0] for d in range(n_data)]
    return {k: (rank0[0][k] if k == "loss" else
                np.concatenate([o[k] for o in rank0]))
            for k in rank0[0]}


def compare(sharded: dict, ref: dict) -> dict:
    """Max |sharded - reference| of the loss, logits and beam logprobs
    (within ATOL; the same entries finite), with the tokens, lengths and
    steps checked equal."""
    diffs = {}
    for key, a in sharded.items():
        b = ref[key]
        if key in ("loss", "logits", "beam_lp"):
            finite = np.isfinite(b) & (np.abs(b) < 1e30)
            d = float(np.max(np.abs(np.where(finite, a - b, 0))))
            if d > ATOL or not np.array_equal(finite, np.isfinite(a)
                                              & (np.abs(a) < 1e30)):
                raise AssertionError(f"{key}: {d} from one rank (> {ATOL})")
            diffs[key] = d
        elif not np.array_equal(a, b):
            raise AssertionError(f"{key} differs from one rank's")
    return diffs


def dryrun_multichip(n_devices: int, device=None,
                     backend: str | None = None) -> list[dict]:
    """Spawn n_devices ranks and run the sharded train and serving steps
    on the main mesh and the reduced pass on its sub-meshes, each held to
    one rank's run; print the stages each mesh shape ran (the reference's
    report) and return, per mesh shape, its name, stages, assembled
    outputs and differences from one rank."""
    dev = str(resolve_device(device))
    results = world.run_world(_rank, n_devices, n_devices, dev, device=dev,
                              backend=backend)
    report = []
    for i, (n, n_model, _) in enumerate(_shapes(n_devices)):
        passes = [r["passes"][i] for r in results]
        outputs = _assemble(passes, n_model)
        for key in ("greedy_length", "spec_length", "beam_step"):
            if key in outputs and outputs[key].max() < 1:
                raise AssertionError(f"{key}: no slot decoded a token")
        diffs = compare(outputs, results[0]["references"][i])
        report.append({"mesh": f"{n // n_model}x{n_model}", "devices": n,
                       "stages": passes[0]["stages"], "outputs": outputs,
                       "diffs": diffs})
    for r in report:
        print(f"dryrun mesh {r['mesh']} (data x model, {r['devices']} "
              f"devices): " + ", ".join(f"{s} OK" for s in r["stages"]))
        print(f"dryrun mesh {r['mesh']} against one rank: tokens equal, "
              + ", ".join(f"{k} max |d| {v:.3g}"
                          for k, v in r["diffs"].items()))
    print(f"dryrun_multichip OK: {n_devices} devices; {len(report)} mesh "
          f"shapes ({', '.join(r['mesh'] for r in report)}); stages: "
          f"{', '.join(report[0]['stages'])}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
