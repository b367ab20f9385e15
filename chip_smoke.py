"""Chip smoke test of the PyTorch/CUDA port (openhush_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
     the build of every kernel in openhush_tpu_torch/csrc (nvcc, sm_90a);
  2. each kernel of the transcription path against its plain PyTorch version
     on the same inputs on the card, at the shapes the path gives it
     (large-v3, one 30 s window), with its time, the plain version's, the
     least time the card could take (bound) and, where one PyTorch call
     computes the same function, that call's time;
  3. a small-input reference check: the "tiny" model in fp32 on the card
     (kernels) against the same weights on the CPU (plain versions);
  4. the main path: WhisperEngine("large-v3", bf16, random weights from seed
     0) transcribes two requests (about 20 s and 45 s of speech-like audio),
     with every kernel's launch count read over exactly that run;
     then one window's greedy decode under torch.profiler (host wall per
     decoder call, device busy time and idle share, top kernels);
  5. the CLI: `python -m openhush_tpu_torch.cli transcribe <wav> --model
     large-v3 --random-init --format json` in a subprocess;
then a `{"kernels": [...]}` line and, last, the `{"ok": true, "device": ...}`
line. Any failure raises, so the script exits non-zero and prints no result.
It never runs on the CPU: without CUDA it exits 1 at once.
"""

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
# Output tokens per window in the main-path run (the depth cut that keeps
# this script within its time limit; the engine's default is 224).
MAX_NEW_TOKENS = 96
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, by CUDA
    events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[kind] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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

    # K2: encoder attention, B=1, 20 heads, T=1500, Dh=64, bf16, read
    # through the strided [B, T, H*Dh] projection layout as encode() does.
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, H, T, D = 1, 20, 1500, 64
    qkv = [torch.randn(B, T, H * D, generator=g, device=dev).to(torch.bfloat16)
           .view(B, T, H, D).transpose(1, 2) for _ in range(3)]
    ours = flash_attention.flash_attention(*qkv)
    plain = flash_attention.attend(*qkv)
    torch.cuda.synchronize()
    err = (ours.float() - plain.float()).abs().max().item()
    tol = 1e-2   # bf16 outputs; the plain version rounds probs to bf16
    log(f"K2 flash_attention: max_abs_err {err:.3e} (tolerance {tol})")
    check(err <= tol, "K2 flash_attention vs plain")
    b, by = bound_ms(4 * B * H * T * D * 2, 4 * B * H * T * T * D, "bf16")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append(dict(
        name="flash_attention",
        source="openhush_tpu_torch/csrc/flash_attention.cu",
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
    gpu = {k: {n: (t.cuda() if torch.is_tensor(t) else
                   {m: u.cuda() for m, u in t.items()})
               for n, t in v.items()} for k, v in cpu.items()}
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


def phase_main_path(WhisperEngine, counters, n_layer):
    eng = WhisperEngine("large-v3", dtype="bfloat16", allow_random_init=True)
    requests = [speechlike(20.0, SEED + 2), speechlike(45.0, SEED + 3)]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
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
    return launches, eng


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
    busy, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from openhush_tpu_torch.models.whisper import decoding, weights
    from openhush_tpu_torch.models.whisper import model as whisper
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.ops import (_build, flash_attention, frontend, mel,
                                        quantize)
    from openhush_tpu_torch.runtime.engine import WhisperEngine

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

    t = time.monotonic()
    rows = phase_kernels(frontend, flash_attention, quantize, mel)
    log(f"phase 2 kernels vs plain: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    phase_reference(WhisperEngine, decoding, whisper, weights, get_config,
                    frontend, mel, quantize)
    log(f"phase 3 tiny fp32 card vs CPU: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    counters = [r["counter"] for r in rows]
    launches, eng = phase_main_path(WhisperEngine, counters,
                                    get_config("large-v3").n_audio_layer)
    log(f"phase 4 main path: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    phase_trace(eng, decoding, whisper, frontend)
    del eng
    log(f"phase 4b decode trace: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    phase_cli()
    log(f"phase 5 CLI: {time.monotonic() - t:.1f} s")

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
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
