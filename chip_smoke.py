"""Chip smoke test of the PyTorch/CUDA port (openhush_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     the build of every kernel in openhush_tpu_torch/csrc (nvcc, sm_90a;
     ptxas's registers and spills), and the count of wgmma instructions in
     K2's bf16 kernel and in K6;
  2. each kernel of the transcription path against its plain PyTorch version
     on the same inputs on the card, at the shapes the path gives it
     (large-v3, one 30 s window; for the decode attention K4/K5, the
     serving step at 8 slots), with its time, the plain version's, the
     least time the card could take (bound) and, where one PyTorch call
     computes the same function, that call's time; K2 in bf16 also at
     batch 2, at a T that is not a multiple of its tiles and on contiguous
     heads; K4 and K5 are each held to themselves bit for bit over two
     launches, K4 checked on an fp32 cache of 448 rows (streamed through
     its ring) and a bf16 one at batch 1, K5 at an odd head count (its
     one-head kernel) and on three causal queries, both timed at batch 1
     beside their bounds and checked in the TPU kernel's own function; the
     encoder attention's backward kernels K6 (dK, dV; also at T=333 and
     the same bits over two launches) and K7 (dQ) and K2's residual output
     in fp32 and bf16, timed at the fine-tune's shape beside K2's fp32
     bound and SDPA's fp32 forward;
  3. a small-input reference check: the "tiny" model in fp32 on the card
     (kernels) against the same weights on the CPU (plain versions); then
     an EngineServer on the card (three windows over two slots, t=0)
     against the one-shot greedy loop on the card: the same tokens; then
     3 train_steps of "tiny" on the card against the CPU (losses and the
     first step's gradients);
  4. the one-shot path: WhisperEngine("large-v3", bf16, random weights from
     seed 0) transcribes two requests (about 20 s and 45 s of speech-like
     audio), with every kernel's launch count read over exactly that run;
     then one window's greedy decode under torch.profiler (host wall per
     decoder call, device busy time and idle share, top kernels);
  4c. the serving path: make_server with 8 slots on the same weights and
     longform.transcribe_files on 8 requests of 5-45 s, with every
     kernel's launch count read over exactly that run, then a few steps at
     8 busy slots under a device-only trace;
  5. the CLI in a subprocess: `python -m openhush_tpu_torch.cli transcribe
     <wav> --model large-v3 --random-init --format json`, then the same with
     three WAVs (the serving path: a JSON list);
  6. the training path: `finetune` on large-v3 in fp32 (random weights from
     seed 0) over two synthetic WAVs, 5 steps, with the launch counts of the
     encoder attention's forward in residual mode (K2) and of its backward
     kernels (K6, K7) read over exactly that run;
then a `{"kernels": [...]}` line (launches from the serving path for K1-K5,
from the fine-tune for K6 and K7) and, last,
the `{"ok": true, "device": ...}` line. Any failure raises, so the script
exits non-zero and prints no result. It never runs on the CPU: without CUDA
it exits 1 at once.
"""

import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Output tokens per window in the main-path runs (the depth cut that keeps
# this script within its time limit; the engine's default is 224).
MAX_NEW_TOKENS = 96
SERVE_SLOTS = 8
N_LAYER = 32                 # large-v3's decoder layers
SERVE_SECS = (5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 38.0, 45.0)
# Spin-kernel cycles per second: the H100's top SM clock (1.98 GHz); a
# slower clock only makes the spin longer.
SPIN_CYCLES_PER_S = 2.0e9
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, by CUDA
    events after a warm-up. A spin kernel first holds the card for twice
    the time the host takes to queue the calls, so the events time the
    device's work and not the rate at which Python launches it (a kernel
    wrapper costs tens of microseconds of host time, more than the decode
    kernels take)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s + 1e-3) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotate(calls):
    """One call after another from `calls`, round and round: each launch
    reads another layer's buffers, as the decode step does."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def bound_ms(n_bytes: float, n_flops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[kind] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_time(prof):
    """Device busy time (us) of a device-only torch.profiler trace, and its
    time by kernel name."""
    busy, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    return busy, by_name


def speechlike(secs: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.5 * t)
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase_kernels(frontend, flash_attention, quantize, mel):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    rows = []

    # K1: log-mel of one 30 s window, 128 mels (large-v3), fp32.
    audio = torch.from_numpy(speechlike(30.0, SEED))[None].to(dev)
    n_frames, n_mels = mel.N_FRAMES, 128
    ours = frontend.log_mel(audio, n_mels)
    plain = mel.log_mel_spectrogram(audio, n_mels)
    torch.cuda.synchronize()
    err = (ours - plain).abs().max().item()
    tol = 1e-3   # normalized log-mel; fp32 sums in another order
    log(f"K1 log_mel: max_abs_err {err:.3e} (tolerance {tol})")
    check(err <= tol, "K1 log_mel vs plain")
    flops = 2 * (2 * n_frames * mel.N_FFT * 201) + 2 * n_frames * 201 * n_mels
    nbytes = 4 * (audio.numel() + 2 * mel.N_FFT * 201 + 201 * n_mels
                  + n_frames * n_mels)
    b, by = bound_ms(nbytes, flops, "fp32")
    rows.append(dict(
        name="log_mel", source="openhush_tpu_torch/csrc/frontend.cu",
        replaces="openhush_tpu/ops/frontend_pallas.py:80",
        counter=frontend.log_mel_energies, max_abs_err=err,
        ms=time_ms(lambda: frontend.log_mel_energies(audio, n_mels, n_frames)),
        plain_ms=time_ms(lambda: mel.log_mel_energies(audio, n_mels, n_frames)),
        bound_ms=b, bound_by=by, library_ms=None))

    # K2: encoder attention, 20 heads, Dh=64, bf16 (the tensor-core kernel),
    # read through the strided [B, T, H*Dh] projection layout as encode()
    # does: B=1, T=1500 (checked, then timed), then B=2 at T=1500 and at
    # T=333 (not a multiple of the 128-query or 64-key tiles), and B=1 on
    # contiguous [B, H, T, Dh] heads (the tensor maps' other stride order).
    g = torch.Generator(device=dev).manual_seed(SEED)
    H, D = 20, 64
    tol = 1e-2   # bf16 outputs; P rounded to bf16 (unnormalised, here)

    def k2_inputs(B, T, heads_first=False):
        x = [torch.randn(B, T, H * D, generator=g, device=dev)
             .to(torch.bfloat16).view(B, T, H, D) for _ in range(3)]
        return [t.permute(0, 2, 1, 3).contiguous() if heads_first
                else t.transpose(1, 2) for t in x]

    for B, T, heads_first in ((1, 1500, False), (2, 1500, False),
                              (2, 333, False), (1, 200, True)):
        qkv = k2_inputs(B, T, heads_first)
        ours = flash_attention.flash_attention(*qkv)
        plain = flash_attention.attend(*qkv)
        torch.cuda.synchronize()
        e = (ours.float() - plain.float()).abs().max().item()
        log(f"K2 flash_attention (bf16, B={B}, T={T}, "
            f"{'contiguous heads' if heads_first else 'projection layout'}"
            f"): max_abs_err {e:.3e} (tolerance {tol})")
        check(e <= tol and bool(torch.isfinite(ours).all()),
              f"K2 flash_attention vs plain, B={B}, T={T}")
        if (B, T) == (1, 1500):
            err, main_qkv = e, qkv
    qkv, (B, T) = main_qkv, (1, 1500)
    b, by = bound_ms(4 * B * H * T * D * 2, 4 * B * H * T * T * D, "bf16")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append(dict(
        name="flash_attention",
        source="openhush_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="openhush_tpu/models/whisper/model.py:158",
        counter=flash_attention.flash_attention, max_abs_err=err,
        ms=time_ms(lambda: flash_attention.flash_attention(*qkv)),
        plain_ms=time_ms(lambda: flash_attention.attend(*qkv)),
        bound_ms=b, bound_by=by, library_ms=time_ms(lambda: sdpa(*qkv))))

    # K3: per-head int8 quantize of one cross-KV tensor, [1, 1500, 1280] bf16.
    x = (3 * torch.randn(1, T, H * D, generator=g, device=dev)
         ).to(torch.bfloat16)
    q, s = quantize.quantize_heads(x, H)
    qp, sp = quantize.quantize_heads_plain(x, H)
    torch.cuda.synchronize()
    s_err = (s - sp).abs().max().item()
    dq = (q.int() - qp.int()).abs()
    err = dq.max().item()
    frac = dq.ne(0).float().mean().item()
    log(f"K3 quantize_heads: scales max_abs_err {s_err:.3e} (tolerance 0), "
        f"int8 levels max_abs_err {err} on {frac:.2e} of elements "
        f"(tolerance 1 level on <= 1e-3: .5 ties)")
    check(s_err == 0 and err <= 1 and frac <= 1e-3, "K3 quantize vs plain")
    b, by = bound_ms(x.numel() * 2 + q.numel() + s.numel() * 4,
                     3 * x.numel(), "bf16")
    rows.append(dict(
        name="quantize_heads", source="openhush_tpu_torch/csrc/quantize_heads.cu",
        replaces="openhush_tpu/ops/quantize_pallas.py:56",
        counter=quantize.quantize_heads, max_abs_err=float(err),
        ms=time_ms(lambda: quantize.quantize_heads(x, H)),
        plain_ms=time_ms(lambda: quantize.quantize_heads_plain(x, H)),
        bound_ms=b, bound_by=by, library_ms=None))
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"library {r['library_ms']}")
    return rows


def phase_decode_attention(da, quantize):
    """K4 and K5 at the serving step's shapes (large-v3, 8 slots, one query
    per row): the self-attention over the bf16 cache (T = 128, per-row
    positions, causal) on the direct path (K4), the cross-attention over
    the int8 cross-KV (T = 1500) on the cluster split (K5). Each mode also
    runs on the other kernel: each within the plain version's tolerance,
    and K5 the same bits over two launches."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    B, H, D, T_self, T_cross = SERVE_SLOTS, 20, 64, 128, 1500
    HD = H * D
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    paths = (da.attend_decode, da.attend_decode_pipelined)
    rows = []

    # Self-attention, bf16: query s=0 of row b sees pos_b + 1 keys.
    q = rnd(B, 1, HD).to(torch.bfloat16)
    k, v = (rnd(B, T_self, HD).to(torch.bfloat16) for _ in range(2))
    lengths = (torch.randint(0, T_self, (B,), generator=g, device=dev)
               + 1).to(torch.int32)
    args = (q, k, v, lengths, H)
    (o4, p4), (o4b, p4b), (o5, p5), (o5b, p5b) = (
        fn(*args, causal=True, return_probs=True)
        for fn in (paths[0], paths[0], paths[1], paths[1]))
    plain, p_plain = da.attend_decode_plain(*args, causal=True,
                                            return_probs=True)
    torch.cuda.synchronize()
    check(torch.equal(o4, o4b) and torch.equal(p4, p4b),
          "K4 bf16 self-attention: the same bits over two launches")
    check(torch.equal(o5, o5b) and torch.equal(p5, p5b),
          "K5 bf16 self-attention: the same bits over two launches")
    tol = 1e-2   # bf16 outputs (an ulp is 7.8e-3 at 1); fp32 sums reordered
    for name, o, p in (("K4 attend_decode", o4, p4),
                       ("  K5 path", o5, p5)):
        e = (o.float() - plain.float()).abs().max().item()
        perr = (p - p_plain).abs().max().item()
        log(f"{name} (bf16 self, T={T_self}, causal, per-row lengths): "
            f"max_abs_err {e:.3e} (tolerance {tol}), bf16 probs max_abs_err "
            f"{perr:.3e}")
        check(e <= tol, f"{name.strip()} bf16 self-attention vs plain")
    err = (o4.float() - plain.float()).abs().max().item()
    log("  K4 and K5 bf16 self-attention: each the same bits over two "
        "launches")
    # The one-shot engine's cache is n_text_ctx = 448 rows: K4 with every
    # row visible, on an fp32 cache (K and V of 448 rows, 224 KB, stream
    # through its ring) and on a bf16 cache at batch 1 (all in flight).
    for dtype, nb, tol in ((torch.float32, 2, 1e-5), (torch.bfloat16, 1, tol)):
        qx = rnd(nb, 1, HD).to(dtype)
        kx, vx = (rnd(nb, 448, HD).to(dtype) for _ in range(2))
        lx = torch.full((nb,), 448, dtype=torch.int32, device=dev)
        ox = da.attend_decode(qx, kx, vx, lx, H)
        e = (ox.float() - da.attend_decode_plain(qx, kx, vx, lx, H).float()
             ).abs().max().item()
        log(f"  K4 {dtype}, B={nb}, T=448, n=448: max_abs_err {e:.3e} "
            f"(tolerance {tol}: fp32 sums over 448 keys reordered"
            f"{'; bf16 outputs' if dtype == torch.bfloat16 else ''})")
        check(e <= tol, f"K4 {dtype} T=448 vs plain")
    n_keys = int(lengths.sum())          # the rows this data needs read
    b, by = bound_ms(2 * n_keys * HD * 2 + 2 * B * HD * 2 + 4 * B,
                     4 * n_keys * HD, "fp32")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = lambda x: x.view(B, -1, H, D).transpose(1, 2)
    mask = (torch.arange(T_self, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    lib = sdpa(heads(q), heads(k), heads(v), attn_mask=mask)
    lib_err = (lib.transpose(1, 2).reshape(B, 1, HD).float()
               - plain.float()).abs().max().item()
    log(f"  SDPA (boolean mask) vs plain: max_abs_err {lib_err:.3e}")
    # Timed over one cache copy per decoder layer, each launch on the next:
    # the step finds every layer's cache cold in the 50 MB L2.
    self_layers = [(k.clone(), v.clone()) for _ in range(N_LAYER)]
    on_layers = lambda fn, **kw: rotate([
        functools.partial(fn, q, kl, vl, lengths, H, causal=True, **kw)
        for kl, vl in self_layers])
    rows.append(dict(
        name="decode_attention_direct",
        source="openhush_tpu_torch/csrc/decode_attention.cu",
        replaces="openhush_tpu/ops/decode_attention.py:133",
        counter=da.attend_decode, max_abs_err=err,
        ms=time_ms(on_layers(da.attend_decode), iters=2 * N_LAYER),
        plain_ms=time_ms(on_layers(da.attend_decode_plain)),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(rotate([
            functools.partial(sdpa, heads(q), heads(kl), heads(vl),
                              attn_mask=mask) for kl, vl in self_layers]),
            iters=2 * N_LAYER)))
    log(f"  K5 path on these shapes: "
        f"{time_ms(on_layers(da.attend_decode_pipelined), iters=2 * N_LAYER):.4f} ms")
    del self_layers

    # Cross-attention, int8 with per-(position, head) scales.
    q = rnd(B, 1, HD).to(torch.bfloat16)
    xk_f, xv_f = (rnd(B, T_cross, HD).to(torch.bfloat16) for _ in range(2))
    (k8, ks), (v8, vs) = (quantize.quantize_heads_plain(x, H)
                          for x in (xk_f, xv_f))
    lengths = torch.tensor([1500, 1499, 1400, 1024, 777, 300, 64, 1],
                           dtype=torch.int32, device=dev)
    for lens in (lengths, None):
        args = (q, k8, v8, lens, H)
        (o4, p4), (o5, p5), (o5b, p5b) = (
            fn(*args, ks=ks, vs=vs, return_probs=True)
            for fn in paths + paths[1:])
        plain, p_plain = da.attend_decode_plain(*args, ks=ks, vs=vs,
                                                return_probs=True)
        torch.cuda.synchronize()
        check(torch.equal(o5, o5b) and torch.equal(p5, p5b),
              "K5 int8 cross-attention: the same bits over two launches")
        n_vis = H * (int(lens.sum()) if lens is not None else B * T_cross)
        for name, o, p in (("K5 attend_decode_pipelined", o5, p5),
                           ("  K4 path", o4, p4)):
            e = (o.float() - plain.float()).abs().max().item()
            dp = (p - p_plain).abs()
            share = dp.ne(0).sum().item() / n_vis
            log(f"{name} (int8 cross, T={T_cross}, lengths "
                f"{'per row' if lens is not None else 'all'}): max_abs_err "
                f"{e:.3e} (tolerance 1e-2: bf16 outputs, and a prob level "
                f"moved at a .5 tie moves an output by at most "
                f"max_t(p*vs)); int8 prob levels max diff "
                f"{dp.max().item():.0f} on {share:.2e} of visible keys "
                f"(tolerance 1 level on <= 1e-3)")
            check(e <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3,
                  f"{name.strip()} int8 cross-attention vs plain")
        err = (o5.float() - plain.float()).abs().max().item()
        log("  K5 int8 cross-attention: the same bits over two launches")
    # K5 takes int8 heads in pairs when their count is even (above): an odd
    # count runs its one-head kernel; S = 3 causal queries (a prefill) the
    # pairs with per-query lengths.
    for n_head, S, causal in ((5, 1, False), (H, 3, True)):
        hx = rnd(2, S, n_head * D).to(torch.bfloat16)
        (kx, ksx), (vx, vsx) = (quantize.quantize_heads_plain(
            rnd(2, T_cross, n_head * D).to(torch.bfloat16), n_head)
            for _ in range(2))
        lx = torch.tensor([T_cross - 1, 9], dtype=torch.int32, device=dev)
        args = (hx, kx, vx, lx, n_head)
        kw = dict(ks=ksx, vs=vsx, causal=causal, return_probs=True)
        o5, p5 = da.attend_decode_pipelined(*args, **kw)
        plain, p_plain = da.attend_decode_plain(*args, **kw)
        e = (o5.float() - plain.float()).abs().max().item()
        dp = (p5 - p_plain).abs()
        n_vis = n_head * sum(min(int(n) + (s if causal else 0), T_cross)
                             for n in lx for s in range(S))
        share = dp.ne(0).sum().item() / n_vis
        log(f"  K5 int8, {n_head} heads, S={S}{', causal' if causal else ''}:"
            f" max_abs_err {e:.3e} (tolerance 1e-2), prob levels max diff "
            f"{dp.max().item():.0f} on {share:.2e} of visible keys")
        check(e <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3,
              f"K5 int8 {n_head} heads S={S} vs plain")
    cross_bound = lambda nb: bound_ms(
        2 * nb * T_cross * HD + 2 * nb * T_cross * H * 4 + 2 * nb * HD * 2,
        4 * nb * T_cross * HD, "fp32")
    b, by = cross_bound(B)
    cross_layers = [tuple(x.clone() for x in (k8, v8, ks, vs))
                    for _ in range(N_LAYER)]
    on_layers = lambda fn, batch=slice(None): rotate([
        functools.partial(fn, q[batch], kl[batch], vl[batch], None, H,
                          ks=ksl[batch], vs=vsl[batch])
        for kl, vl, ksl, vsl in cross_layers])
    rows.append(dict(
        name="decode_attention_pipelined",
        source="openhush_tpu_torch/csrc/decode_attention.cu",
        replaces="openhush_tpu/ops/decode_attention_dma.py:101",
        counter=da.attend_decode_pipelined, max_abs_err=err,
        ms=time_ms(on_layers(da.attend_decode_pipelined), iters=2 * N_LAYER),
        plain_ms=time_ms(on_layers(da.attend_decode_plain)),
        bound_ms=b, bound_by=by, library_ms=None))
    log(f"  K4 path on these shapes: "
        f"{time_ms(on_layers(da.attend_decode), iters=2 * N_LAYER):.4f} ms")

    # The one-shot engine's step is batch 1: its times (K5's row keeps its
    # batch-1 time beside that batch's bound).
    lens1 = torch.tensor([100], dtype=torch.int32, device=dev)
    self_b1 = [tuple(x[:1, :T_self].clone() for x in (xk_f, xv_f))
               for _ in range(N_LAYER)]
    for fn in paths:
        self_ms = time_ms(rotate([
            functools.partial(fn, q[:1], kl, vl, lens1, H, causal=True)
            for kl, vl in self_b1]), iters=2 * N_LAYER)
        cross_ms = time_ms(on_layers(fn, slice(0, 1)), iters=2 * N_LAYER)
        log(f"  batch 1 ({fn.__name__}): bf16 self T={T_self} (100 keys) "
            f"{self_ms:.4f} ms, int8 cross T={T_cross} {cross_ms:.4f} ms")
        if fn is da.attend_decode:
            # 100 visible keys of K and V, the query and the output, bf16.
            rows[0]["batch1_ms"] = self_ms
            rows[0]["batch1_bound_ms"] = bound_ms(
                2 * 100 * HD * 2 + 2 * HD * 2 + 4, 4 * 100 * HD, "fp32")[0]
        else:
            rows[-1]["batch1_ms"] = cross_ms
            rows[-1]["batch1_bound_ms"] = cross_bound(1)[0]
    del cross_layers, self_b1

    # The TPU kernels' own function: q pre-scaled, no scales, int8 values
    # taken as numbers; both paths, int8 and bf16 K/V, t_actual < T.
    q2 = (q[:, 0].float() * D ** -0.5).to(torch.bfloat16)
    for kk, vv, what in ((k8, v8, "int8"), (xk_f, xv_f, "bf16")):
        ref = da.decode_cross_attend_plain(q2, kk, vv, H, 1400).float()
        for pipelined in (False, True):
            out = da.decode_cross_attend(q2, kk, vv, H, 1400,
                                         pipelined=pipelined).float()
            e = (out - ref).abs().max().item()
            if what == "int8":
                e /= ref.abs().max().item()
            log(f"  decode_cross_attend ({what}, t_actual 1400, "
                f"{'pipelined' if pipelined else 'direct'}): "
                f"{'relative ' if what == 'int8' else ''}max_err {e:.3e} "
                f"(tolerance 2e-2)")
            check(e <= 2e-2, f"decode_cross_attend {what} vs plain")
    return rows


def phase_flash_backward(fa, k2_row):
    """K2's residual mode (the per-row log-sum-exp), K6 (dK, dV) and K7 (dQ)
    at the large-v3 encoder's shapes (20 heads, T=1500, Dh=64, read through
    the strided [B, T, H*Dh] projection layout as encode() does): against
    their plain versions on the same inputs, in fp32 at the fine-tune
    phase's shape (B=2) and in bf16 at B=1; then timed on the fp32 B=2
    inputs that were checked, beside their bounds and the backward of SDPA
    on the same inputs. K2's fp32 residual-mode time, its fp32 bound and
    SDPA's fp32 forward on the same inputs go into K2's row (`k2_row`)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    H, T, D = 20, 1500, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def compare(B, dtype):
        """K2's residual mode, K6 and K7 against their plain versions on one
        set of inputs → (K6/K7's inputs, absolute errors of dq, dk, dv).
        Max abs error relative to max|plain| per tensor: fp32 sums over 1500
        keys in another order; bf16 outputs round to 8 bits of mantissa."""
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        o_tol = 1e-4 if dtype == torch.float32 else 1e-2
        q, k, v, do = [torch.randn(B, T, H * D, generator=g, device=dev)
                       .to(dtype).view(B, T, H, D).transpose(1, 2)
                       for _ in range(4)]
        o, lse = fa.flash_attention_lse(q, k, v)
        o_plain, lse_plain = fa.attend_lse(q, k, v)
        delta = fa.delta_rows(o, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        ref = fa.attend_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        lse_err = (lse - lse_plain).abs().max().item()
        o_err = (o.float() - o_plain.float()).abs().max().item()
        abs_errs = {n: (a.float() - b.float()).abs().max().item()
                    for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        errs = {n: e / b.float().abs().max().item()
                for (n, e), b in zip(abs_errs.items(), ref)}
        log(f"K2 residual mode ({dtype}, B={B}): lse max_abs_err "
            f"{lse_err:.3e} (tolerance 1e-4), output max_abs_err {o_err:.3e} "
            f"(tolerance {o_tol})")
        log(f"K6/K7 vs attend_backward ({dtype}, B={B}): max_abs_err / "
            f"max|plain| " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tolerance {tol})")
        check(lse_err <= 1e-4 and o_err <= o_tol, "K2 residual mode")
        check(all(e <= tol for e in errs.values()), "K6/K7 vs plain")
        return (q, k, v, do, lse, delta), abs_errs

    compare(1, torch.bfloat16)
    # K6 at a T that is not a multiple of its 128-key or 64-query tiles.
    x = [torch.randn(1, 333, H * D, generator=g, device=dev).view(
        1, 333, H, D).transpose(1, 2) for _ in range(4)]
    o, lse = fa.attend_lse(*x[:3])
    rest = (x[3], lse, fa.delta_rows(o, x[3]))
    rel = max((a - b).abs().max().item() / b.abs().max().item() for a, b in
              zip(fa.flash_attention_bwd_dkv(*x[:3], *rest),
                  fa.backward_dkv_plain(*x[:3], *rest)))
    log(f"K6 (fp32, B=1, T=333): max_abs_err / max|plain| {rel:.3e} "
        f"(tolerance 1e-4)")
    check(rel <= 1e-4, "K6 fp32 T=333 vs plain")
    # The fine-tune's shape, fp32: these inputs are checked, then timed, and
    # their errors are the kernels line's max_abs_err.
    B = 2
    args, abs_errs = compare(B, torch.float32)
    first, again = (fa.flash_attention_bwd_dkv(*args) for _ in range(2))
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "K6: the same bits over two launches")
    log("  K6 (fp32, B=2): the same bits over two launches")
    err_dkv = max(abs_errs["dk"], abs_errs["dv"])
    err_dq = abs_errs["dq"]
    q, k, v, do = args[:4]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves)
    lib = lambda wrt: time_ms(lambda: torch.autograd.grad(
        out, wrt, do, retain_graph=True))
    elems = B * H * T * D * 4            # one fp32 [B, H, T, Dh] tensor
    rows_bytes = 2 * B * H * T * 4       # lse and delta
    k2_ms = time_ms(lambda: fa.flash_attention_lse(q, k, v))
    k2_sdpa_ms = time_ms(lambda: sdpa(q, k, v))
    # Four fp32 [B, H, T, Dh] tensors and the lse moved; 2 T x T x Dh products.
    k2_bound, k2_by = bound_ms(4 * elems + B * H * T * 4,
                               4 * B * H * T * T * D, "fp32")
    log(f"  K2 residual mode (fp32, B=2): {k2_ms:.4f} ms, bound "
        f"{k2_bound:.4f} ms ({k2_by}), SDPA fp32 forward {k2_sdpa_ms:.4f} ms;"
        f" inference mode "
        f"{time_ms(lambda: fa.flash_attention(q, k, v)):.4f} ms")
    k2_row.update(fp32_residual_ms=k2_ms, fp32_residual_bound_ms=k2_bound,
                  fp32_residual_library_ms=k2_sdpa_ms)
    rows = []
    for name, fn, plain, wrt, n_out, n_mm, err, src in (
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
             fa.backward_dkv_plain, leaves[1:], 2, 4, err_dkv,
             "flash_attention_bwd_tc.cu"),
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
             fa.backward_dq_plain, leaves[:1], 1, 3, err_dq,
             "flash_attention_bwd.cu")):
        # n_mm T x T x Dh products: S and dP recomputed, then dV and dK (K6)
        # or dQ (K7); each input read once, each output written once.
        n_bytes = (4 + n_out) * elems + rows_bytes
        flops = n_mm * 2 * B * H * T * T * D
        b, by = bound_ms(n_bytes, flops, "fp32")
        rows.append(dict(
            name=name, source="openhush_tpu_torch/csrc/" + src,
            replaces=("jax/experimental/pallas/ops/tpu/flash_attention.py:"
                      + ("941" if n_out == 2 else "1287")),
            counter=fn, max_abs_err=err,
            ms=time_ms(lambda: fn(*args)), plain_ms=time_ms(lambda: plain(*args)),
            bound_ms=b, bound_by=by, library_ms=lib(wrt)))
        if fn is fa.flash_attention_bwd_dkv:
            # On the tensor cores each fp32 product is six bf16 products
            # (three bf16 parts an operand): the least time for the same
            # function at fp32 accuracy. The CUDA-core bound stays beside it.
            rows[-1]["cuda_core_bound_ms"] = b
            rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound_ms(
                n_bytes, 6 * flops, "bf16")
    for r in rows:
        log(f"  {r['name']} (fp32, B=2): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})"
            + (f", fp32 CUDA-core bound {r['cuda_core_bound_ms']:.4f} ms"
               if "cuda_core_bound_ms" in r else "")
            + f", SDPA backward for the same gradients "
            f"{r['library_ms']:.4f} ms")
    return rows


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.detach().clone().to(dev)


def train_batch(cfg, B, S, seed):
    """A numpy batch of mel [B, n_mels, 3000], tokens and targets [B, S]
    (targets the next token, the first three positions ignored)."""
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, cfg.n_mels, 3000)).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, :3] = -100
    return mel, tokens, targets


def phase_train_tiny(train, weights, get_config, fa):
    """tiny, fp32, training: the first step's gradients and the losses of 3
    train_steps on the card (encoder attention on K2's residual mode, K6,
    K7) against the CPU (autograd of the plain attention), from the same
    parameters on the same batch."""
    cfg = get_config("tiny")
    cpu = weights.init_params(cfg, torch.Generator().manual_seed(SEED + 60),
                              torch.float32, "cpu")
    batch = train_batch(cfg, 2, 24, SEED + 61)
    counters = (fa.flash_attention_lse, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_dq)
    out = {}
    for dev in ("cpu", "cuda"):
        for fn in counters:
            fn.launches = 0
        params = to_device(cpu, dev)
        mel, tokens, targets = (torch.from_numpy(a).to(dev) for a in batch)
        opt = train.make_optimizer(lr=1e-4, warmup_steps=1, total_steps=5)
        state = opt.init(params)
        _, grads = train.value_and_grad(cfg, params, mel, tokens, targets)
        losses = [float(train.train_step(cfg, opt, params, state, mel, tokens,
                                         targets)[2]) for _ in range(3)]
        out[dev] = (losses, [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    grad_err = max(((a - b).abs().max() / a.abs().max().clamp(min=1e-12)
                    ).item() for a, b in zip(g_cpu, g_gpu))
    log(f"  tiny fp32 training: losses CPU {l_cpu}, card {l_gpu}; relative "
        f"error {loss_err:.3e} (tolerance 1e-4); first-step gradients max "
        f"abs error / max|CPU| per leaf {grad_err:.3e} (tolerance 1e-3)")
    check(all(math.isfinite(x) for x in l_gpu), "tiny training losses finite")
    check(loss_err <= 1e-4 and grad_err <= 1e-3, "tiny training card vs CPU")
    n = 4 * cfg.n_audio_layer          # value_and_grad, then 3 steps
    check(all(fn.launches == n for fn in counters),
          "the card ran K2 residual mode, K6 and K7 once per encoder layer "
          "and step")


def phase_finetune(data, train, weights, get_config, fa, steps=5):
    """The training path at full width: large-v3 (32+32 layers, d=1280, 128
    mels) in fp32 on random weights from init_params, `finetune` over a
    WhisperDataset of exactly 2 synthetic WAVs (so every epoch is the same
    batch, only its row order changes), batch 2, 64 tokens (S·H = 1280,
    the long regime), `steps` epochs = `steps` steps with warmup 1, lr 1e-5
    (the reference's default). lr is 0 on the first update, so the second
    loss equals the first; the loss then falls. Every encoder layer runs
    K2 in residual mode, K6 and K7 once per step."""
    from openhush_tpu_torch.audio.wav import save_wav
    cfg = get_config("large-v3")
    counters = (fa.flash_attention_lse, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_dq)
    with tempfile.TemporaryDirectory() as tmp:
        lines = []
        for i, (secs, text) in enumerate(((8.0, "the quick brown fox jumps "
                                           "over the lazy dog"),
                                          (12.0, "fine tuning on the card "
                                           "with random weights"))):
            save_wav(os.path.join(tmp, f"utt{i}.wav"),
                     speechlike(secs, SEED + 70 + i))
            lines.append(f"utt{i}.wav\t{text}")
        manifest = os.path.join(tmp, "manifest.tsv")
        with open(manifest, "w") as f:
            f.write("\n".join(lines) + "\n")
        ds = data.WhisperDataset(data.load_manifest(manifest), cfg,
                                 batch_size=2, max_tokens=64, seed=SEED)
        torch.cuda.empty_cache()
        params = weights.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            torch.float32)
        walls = []
        step = train.train_step

        def timed_step(*args):
            t0 = time.monotonic()
            res = step(*args)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            return res

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        train.train_step = timed_step
        try:
            t0 = time.monotonic()
            _, losses = data.finetune(cfg, params, ds, epochs=steps, lr=1e-5)
            wall = time.monotonic() - t0
        finally:
            train.train_step = step
        launches = {fn.__name__: fn.launches for fn in counters}
        trace_batch = next(ds.epoch())        # for the trace below
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in train.leaves(params))
    log(f"  large-v3 fp32 fine-tune: {len(losses)} steps in {wall:.2f} s "
        f"wall, median step {sorted(walls)[len(walls) // 2] * 1e3:.1f} ms "
        f"(steps {[round(w * 1e3, 1) for w in walls]} ms), peak memory "
        f"{peak:.2f} GiB ({n_params / 1e9:.3f} B parameters); losses "
        f"{losses}; launches {launches}")
    n = cfg.n_audio_layer * steps
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          "fine-tune losses finite")
    check(abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0]),
          "loss 2 equals loss 1 (lr 0 on the first update)")
    check(losses[-1] < losses[0], "the fine-tune loss fell")
    check(all(c == n for c in launches.values()),
          f"K2 residual mode, K6 and K7 ran {n} times (32 x steps)")

    # Where a step's time goes: one more step (not counted above), on a
    # fresh optimizer state, under a device-only trace.
    from torch.profiler import ProfilerActivity, profile
    mel, tokens, targets = (torch.from_numpy(a).cuda() for a in (
        trace_batch.mel, trace_batch.tokens, trace_batch.targets))
    opt = train.make_optimizer(lr=1e-5, warmup_steps=1, total_steps=steps)
    state = opt.init(params)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        train.train_step(cfg, opt, params, state, mel, tokens, targets)
        torch.cuda.synchronize()
        traced = time.monotonic() - t0
    busy, by_name = device_time(prof)
    if busy == 0:
        log("  fine-tune trace: the profiler saw no device events; device "
            "time not measured")
    else:
        flash = sum(us for name, us in by_name.items() if "flash" in name)
        log(f"  traced step: {traced * 1e3:.1f} ms wall, device busy "
            f"{busy / 1e3:.1f} ms, device idle share "
            f"{1 - busy / 1e6 / traced:.3f}; flash kernels (K2, K6, K7) "
            f"{flash / 1e3:.1f} ms = {flash / busy:.1%}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {us / busy:6.1%}  {us / 1e3:8.2f} ms  {name[:90]}")
    del params, state, opt
    return launches


def phase_reference(WhisperEngine, decoding, whisper, weights, get_config,
                    frontend, mel, quantize):
    """tiny, fp32: the card (kernels) against the CPU (plain versions) on
    the same weights and the same audio, and the quantize kernel's fp32
    instance against its plain version on the card's cross-K. cuDNN's TF32
    is switched off so the conv stem runs in fp32 on both sides."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tiny")
    cpu = weights.init_params(cfg, torch.Generator().manual_seed(SEED),
                              torch.float32, "cpu")
    gpu = to_device(cpu, "cuda")
    audio = speechlike(8.0, SEED + 1)
    out = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
        eng = WhisperEngine("tiny", params=params, device=dev)
        with torch.inference_mode():
            window = torch.from_numpy(mel.pad_or_trim(audio)).to(dev)[None]
            m = frontend.log_mel(window, cfg.n_mels)
            feats = whisper.encode(cfg, params, m)
            xkv = whisper.compute_cross_kv(cfg, params, feats)
            probs = decoding.detect_language_logits(cfg, params, xkv)
            tok = eng.tokenizer
            prompt = torch.tensor([tok.sot_sequence("en")], device=dev)
            cache = whisper.init_kv_cache(cfg, 1, torch.float32, 64, dev)
            logits, _ = whisper.decode(cfg, params, prompt, 0, cache, xkv)
        out[name] = [t.float().cpu() for t in (m, feats, probs,
                                               logits[..., :cfg.n_vocab])]
    names = ("log-mel", "encoder features", "language probs", "prompt logits")
    tols = (1e-3, 2e-3, 1e-4, 2e-3)
    for n, a, b, tol in zip(names, out["cpu"], out["gpu"], tols):
        err = (a - b).abs().max().item()
        check(bool(torch.isfinite(b).all()), f"{n} finite")
        log(f"  tiny fp32 {n}: card vs CPU max_abs_err {err:.3e} "
            f"(tolerance {tol})")
        check(err <= tol, f"tiny {n} card vs CPU")
    xk = xkv.k[0]                      # the card's fp32 cross-K, layer 0
    (q, s), (qp, sp) = (quantize.quantize_heads(xk, cfg.n_text_head),
                        quantize.quantize_heads_plain(xk, cfg.n_text_head))
    dq = (q.int() - qp.int()).abs()
    log(f"  tiny fp32 int8 quantize: scales max_abs_err "
        f"{(s - sp).abs().max().item():.3e} (tolerance 0), levels max_abs_err "
        f"{dq.max().item()} on {dq.ne(0).float().mean().item():.2e} of "
        f"elements (tolerance 1 on <= 1e-3)")
    check(bool((s == sp).all()) and dq.max().item() <= 1
          and dq.ne(0).float().mean().item() <= 1e-3, "fp32 quantize")
    return cfg, gpu


def phase_server_tiny(cfg, params, WhisperEngine, EngineServer, decoding,
                      whisper, frontend, mel, max_new=32):
    """An EngineServer on the card (tiny, fp32; three windows over two
    slots; t=0, guards off) against the one-shot greedy loop on the card on
    the same windows and the same int8 cross-KV: the same tokens."""
    eng = WhisperEngine("tiny", params=params, device="cuda")
    tok = eng.tokenizer
    audios = [speechlike(secs, SEED + 6 + i)
              for i, secs in enumerate((8.0, 12.0, 20.0))]
    plen = len(tok.sot_sequence("en", "transcribe"))
    srv = EngineServer(cfg, params, n_slots=2, inner_steps=8,
                       dtype=torch.float32, tokenizer=tok,
                       max_decode_len=plen + max_new + 1,
                       temperatures=(0.0,), logprob_threshold=-1e9,
                       no_speech_threshold=2.0, max_admissions_per_turn=2)
    sids = [srv.open_session() for _ in audios]
    for sid, a in zip(sids, audios):
        srv.submit_window(sid, a, language="en")
    got = {}
    for _ in range(200):
        srv.run_once()
        for sid in sids:
            r = srv.poll(sid)
            if r is not None:
                got[sid] = r.tokens
        if len(got) == len(sids):
            break
    check(len(got) == len(sids), "server finished every window")
    opts = decoding.DecodingOptions(language="en", max_new_tokens=max_new)
    eot = tok.special.eot
    with torch.inference_mode():
        for sid, a in zip(sids, audios):
            window = torch.from_numpy(mel.pad_or_trim(a)).cuda()[None]
            feats = whisper.encode(cfg, params, frontend.log_mel(
                window, cfg.n_mels))
            xkv = whisper.compute_cross_kv_quant(cfg, params, feats)
            res = decoding.decode_greedy(cfg, params, xkv, tok, opts)
            ref = []
            for t in res.tokens[0, res.prompt_len:]:
                if t == eot:
                    break
                ref.append(int(t))
            log(f"  tiny fp32 server vs one-shot: {len(got[sid])} tokens, "
                f"{'equal' if got[sid] == ref else 'DIFFERENT'}")
            check(got[sid] == ref, "server tokens == one-shot tokens")


def check_decode_launches(launches, flat_calls, n_layer):
    """Every flat decoder call launches K4 (self) and K5 (cross) once per
    decoder layer."""
    k4 = launches["attend_decode"]
    k5 = launches["attend_decode_pipelined"]
    log(f"  flat decoder calls {flat_calls}: K4 launches {k4}, K5 launches "
        f"{k5} (expected {n_layer} x {flat_calls} = {n_layer * flat_calls})")
    check(flat_calls > 0 and k4 == k5 == n_layer * flat_calls,
          "K4 and K5 ran once per decoder layer and flat decoder call")


def phase_main_path(WhisperEngine, whisper, counters, n_layer):
    eng = WhisperEngine("large-v3", dtype="bfloat16", allow_random_init=True)
    requests = [speechlike(20.0, SEED + 2), speechlike(45.0, SEED + 3)]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    whisper._decode_flat_ro.calls = 0
    t0 = time.monotonic()
    results = [eng.transcribe(a, max_new_tokens=MAX_NEW_TOKENS)
               for a in requests]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    windows = sum(r.windows for r in results)
    audio_s = sum(len(a) for a in requests) / 16000
    langs = eng.tokenizer.special.languages
    for a, r in zip(requests, results):
        dur = len(a) / 16000
        log(f"  request {dur:.0f} s: windows {r.windows}, segments "
            f"{len(r.segments)}, language {r.language}, "
            f"{len(r.text)} chars of text")
        check(r.language in langs and isinstance(r.text, str), "result")
        for s in r.segments:
            check(0.0 <= s.start <= s.end <= dur + 30.0, f"segment {s}")
            check(math.isfinite(s.avg_logprob), "avg_logprob finite")
    log(f"  main path: {windows} windows, {audio_s:.0f} s of audio in "
        f"{wall:.2f} s wall = {audio_s / wall:.2f}x realtime; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches["log_mel_energies"] >= windows, "K1 ran once per window")
    check(launches["flash_attention"] == n_layer * windows,
          "K2 ran once per encoder layer and window")
    check(launches["quantize_heads"] == 2 * n_layer * windows,
          "K3 ran for K and V of every decoder layer and window")
    check_decode_launches(launches, whisper._decode_flat_ro.calls, n_layer)
    return launches, eng


def phase_serving(eng, longform, whisper, counters, n_layer):
    """The serving path: make_server (8 slots) on the one-shot path's
    weights, transcribe_files on 8 requests of 5-45 s, with every kernel's
    launch count read over exactly that run. Then 8 fresh windows fill the
    slots and a few steps run at 8 busy slots: timed on the host clock,
    then under a device-only trace (busy time, idle share)."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, tok = eng.cfg, eng.params, eng.tokenizer
    srv = longform.make_server(cfg, params, tok, n_files=len(SERVE_SECS),
                               n_slots=SERVE_SLOTS,
                               max_new_tokens=MAX_NEW_TOKENS,
                               dtype=torch.bfloat16, temperatures=(0.0,))
    check(srv.n_slots == SERVE_SLOTS, "the budgeter kept 8 slots")
    requests = [speechlike(secs, SEED + 20 + i)
                for i, secs in enumerate(SERVE_SECS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    whisper._decode_flat_ro.calls = 0
    t0 = time.monotonic()
    results = longform.transcribe_files(srv, requests, language="auto")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    flat_calls = whisper._decode_flat_ro.calls
    dispatches = srv.step_dispatches
    windows = sum(r.windows for r in results)
    audio_s = sum(len(a) for a in requests) / 16000
    for a, r in zip(requests, results):
        dur = len(a) / 16000
        check(isinstance(r.text, str) and r.windows >= 1, "serving result")
        for seg in r.segments:
            check(0.0 <= seg.start <= seg.end <= dur + 30.0, f"segment {seg}")
            check(math.isfinite(seg.avg_logprob), "avg_logprob finite")
    log(f"  serving: {len(requests)} requests, {windows} windows, "
        f"{audio_s:.0f} s of audio in {wall:.2f} s wall = "
        f"{audio_s / wall:.2f}x realtime; {dispatches} step dispatches "
        f"({srv.inner_steps} steps each, x{srv.deep_factor} when deep); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")
    check(launches["log_mel_energies"] >= 1
          and launches["flash_attention"] >= n_layer
          and launches["quantize_heads"] >= 2 * n_layer,
          "K1-K3 ran in the server's window preparation")
    check_decode_launches(launches, flat_calls, n_layer)

    # Steady state: 8 busy slots (prepared and admitted, no step yet).
    sids = [srv.open_session() for _ in range(SERVE_SLOTS)]
    for i, sid in enumerate(sids):
        srv.submit_window(sid, speechlike(30.0, SEED + 40 + i),
                          language="en")
    srv._prepare_many([srv._pending.get_nowait() for _ in sids])
    srv._admit_pending()
    check(len(srv._slots) == SERVE_SLOTS, "8 slots admitted")
    n = 2
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        srv._step_state()
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / (n * srv.inner_steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        srv._step_state()
        torch.cuda.synchronize()
        traced = time.monotonic() - t0
    busy, by_name = device_time(prof)
    log(f"  8 busy slots: {per_step * 1e3:.2f} ms host wall per decode step "
        f"untraced ({n} dispatches of {srv.inner_steps} steps)")
    if busy == 0:
        log("  serving trace: the profiler saw no device events; device "
            "time not measured")
    else:
        log(f"  traced dispatch of {srv.inner_steps} steps: "
            f"{traced * 1e3:.1f} ms wall, device busy {busy / 1e3:.2f} ms = "
            f"{busy / 1e3 / srv.inner_steps:.2f} ms/step, device idle share "
            f"{1 - busy / 1e6 / traced:.3f}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"    {us / busy:6.1%}  {us / 1e3:8.2f} ms  {name[:90]}")
    return launches


def phase_trace(eng, decoding, whisper, frontend, steps=32):
    """Where one window's time goes: its greedy decode (t=0, `steps` tokens),
    after a warm-up, timed on the host clock, then again under
    torch.profiler tracing only the device (CUDA kernels and copies), so
    that the trace adds little host time. Prints host wall per decoder
    call, device busy time, idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    cfg = eng.cfg
    with torch.inference_mode():
        window = torch.from_numpy(speechlike(30.0, SEED + 5)).cuda()[None]
        t0 = time.monotonic()
        feats = whisper.encode(cfg, eng.params, frontend.log_mel(
            window, cfg.n_mels).to(eng.dtype))
        xkv = eng._cross_kv(feats)
        torch.cuda.synchronize()
        front_s = time.monotonic() - t0
        opts = decoding.DecodingOptions(language="en", max_new_tokens=steps,
                                        suppress_blank=False)
        run = lambda: decoding.decode_greedy(cfg, eng.params, xkv,
                                             eng.tokenizer, opts)
        run()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        untraced = time.monotonic() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            res = run()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    # Decoder calls: the prefill, then one per sampled token but the last.
    n = min(steps, int((res.tokens[0, res.prompt_len:]
                        != eng.tokenizer.special.eot).sum()) + 1)
    busy, by_name = device_time(prof)
    log(f"  window front (log-mel + encoder + int8 cross-KV): "
        f"{front_s * 1e3:.1f} ms host wall")
    if busy == 0:
        log("  decode trace: the profiler saw no device events; device "
            "time not measured")
        return
    log(f"  decode: {n} decoder calls in {untraced * 1e3:.1f} ms host wall "
        f"untraced = {untraced * 1e3 / n:.2f} ms/call; traced "
        f"{wall * 1e3:.1f} ms; device busy {busy / 1e3:.1f} ms "
        f"= {busy / 1e3 / n:.2f} ms/call; device idle share "
        f"{1 - busy / 1e6 / wall:.3f}; {len(by_name)} kernel names")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        log(f"    {us / busy:6.1%}  {us / 1e3:8.2f} ms  {name[:90]}")


def phase_cli():
    """The CLI in its own process. OPENHUSH_NO_FALLBACK=1 keeps it to the
    t=0 rung: on random weights the ladder would run all six."""
    with tempfile.TemporaryDirectory() as tmp:
        from openhush_tpu_torch.audio.wav import save_wav
        wav = os.path.join(tmp, "request.wav")
        save_wav(wav, speechlike(10.0, SEED + 4))
        env = dict(os.environ, PYTHONPATH=ROOT, OPENHUSH_NO_FALLBACK="1")
        r = subprocess.run(
            [sys.executable, "-m", "openhush_tpu_torch.cli", "transcribe", wav,
             "--model", "large-v3", "--random-init", "--format", "json"],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    check(r.returncode == 0, f"CLI exit {r.returncode}: {r.stderr[-2000:]}")
    data = json.loads(r.stdout)
    check(data["model"] == "large-v3" and data["audio_duration_secs"] == 10.0,
          "CLI JSON")
    log(f"  CLI: rc 0, language {data['language']}, real_time_factor "
        f"{data['real_time_factor']:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        from openhush_tpu_torch.audio.wav import save_wav
        wavs = []
        for i, secs in enumerate((6.0, 9.0, 12.0)):
            wavs.append(os.path.join(tmp, f"request{i}.wav"))
            save_wav(wavs[-1], speechlike(secs, SEED + 30 + i))
        t0 = time.monotonic()
        r = subprocess.run(
            [sys.executable, "-m", "openhush_tpu_torch.cli", "transcribe",
             *wavs, "--model", "large-v3", "--random-init", "--format",
             "json"], capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=600)
        wall = time.monotonic() - t0
    check(r.returncode == 0, f"CLI exit {r.returncode}: {r.stderr[-2000:]}")
    data = json.loads(r.stdout)
    check(isinstance(data, list) and [d["file"] for d in data] == wavs
          and [d["audio_duration_secs"] for d in data] == [6.0, 9.0, 12.0],
          "multi-file CLI JSON list")
    log(f"  CLI, 3 files through the server: rc 0 in {wall:.1f} s, "
        f"languages {[d['language'] for d in data]}")
    log(json.dumps(data))


def phase_sass(so, nvcc: str) -> None:
    """K2's bf16 kernel and K6 run on the tensor cores: count each one's
    warpgroup MMA instructions (HGMMA) in the built library's SASS, by the
    toolkit's cuobjdump, and fail if either has none."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log(f"  {cuobjdump} not found: the SASS not inspected")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    kernels = {"flash_attention_tc_kernel": 0, "flash_bwd_dkv_tc_kernel": 0}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current is not None and "HGMMA" in line:
            kernels[current] += 1
    for name, count in kernels.items():
        log(f"  {name} SASS: {count} HGMMA (wgmma) instructions")
        check(count > 0, f"{name} on the tensor cores (HGMMA in its SASS)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from openhush_tpu_torch.models.whisper import decoding, weights
    from openhush_tpu_torch.models.whisper import model as whisper
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.ops import (_build, decode_attention,
                                        flash_attention, frontend, mel,
                                        quantize)
    from openhush_tpu_torch.runtime import longform
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    from openhush_tpu_torch.runtime.server import EngineServer
    from openhush_tpu_torch.training import data, train

    t = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, matmul allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    so = _build.build()
    _build.library()
    log(f"phase 1 build: {so.name} in {time.monotonic() - t:.1f} s")
    for line in open(str(so) + ".log"):
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())
    phase_sass(so, _build.nvcc())

    t = time.monotonic()
    rows = phase_kernels(frontend, flash_attention, quantize, mel)
    rows += phase_decode_attention(decode_attention, quantize)
    rows += phase_flash_backward(flash_attention, rows[1])
    for r in rows[3:5]:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}), library {r['library_ms']}"
            + (f"; batch 1: kernel {r['batch1_ms']:.4f} ms, bound "
               f"{r['batch1_bound_ms'] * 1e3:.2f} us" if "batch1_ms" in r
               else ""))
    log(f"phase 2 kernels vs plain: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    cfg_tiny, tiny_gpu = phase_reference(WhisperEngine, decoding, whisper,
                                         weights, get_config, frontend, mel,
                                         quantize)
    phase_server_tiny(cfg_tiny, tiny_gpu, WhisperEngine, EngineServer,
                      decoding, whisper, frontend, mel)
    del tiny_gpu
    phase_train_tiny(train, weights, get_config, flash_attention)
    log(f"phase 3 tiny fp32 card vs CPU, server vs one-shot, training: "
        f"{time.monotonic() - t:.1f} s")

    t = time.monotonic()
    counters = [r["counter"] for r in rows]
    n_layer = get_config("large-v3").n_text_layer
    _, eng = phase_main_path(WhisperEngine, whisper, counters, n_layer)
    log(f"phase 4 one-shot path: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    phase_trace(eng, decoding, whisper, frontend)
    log(f"phase 4b decode trace: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    launches = phase_serving(eng, longform, whisper, counters, n_layer)
    del eng
    log(f"phase 4c serving path: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    phase_cli()
    log(f"phase 5 CLI: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    launches.update(phase_finetune(data, train, weights, get_config,
                                   flash_attention))
    log(f"phase 6 large-v3 fine-tune: {time.monotonic() - t:.1f} s")

    kernels = []
    for r in rows:
        fn = r.pop("counter")
        kernels.append({"name": r["name"], "route": "cuda",
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches[fn.__name__],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        for key in ("batch1_ms", "batch1_bound_ms", "cuda_core_bound_ms",
                    "fp32_residual_ms",
                    "fp32_residual_bound_ms", "fp32_residual_library_ms"):
            if key in r:
                kernels[-1][key] = r[key]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
