"""Chip smoke test of the PyTorch/CUDA port (openhush_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     the build of every kernel in openhush_tpu_torch/csrc (nvcc, sm_90a;
     ptxas's registers and spills), and the count of wgmma instructions in
     K2's bf16 and fp32 kernels, K6 and K7 (cuobjdump; a missing cuobjdump
     fails the phase);
  2. each kernel of the transcription path against its plain PyTorch version
     on the same inputs on the card, at the shapes the path gives it
     (large-v3, one 30 s window; for the decode attention K4/K5, the
     serving step at 8 slots), with its time, the plain version's, the
     least time the card could take (bound) and, where one PyTorch call
     computes the same function, that call's time; K1's log10 energies
     before the clamp also at batch 2, at 80 mels, at 1500 frames and, on a
     tone over near silence, against float64 sums; K3 through its K+V entry
     (one launch a layer, into a slice of stacked buffers) and on one
     tensor, timed both ways, also in fp32 and at head dims of 32, 80 and
     128; K2 in bf16 also at
     batch 2, at a T that is not a multiple of its tiles and on contiguous
     heads; K4 and K5 are each held to themselves bit for bit over two
     launches, K4 checked on an fp32 cache of 448 rows (streamed through
     its ring) and a bf16 one at batch 1, K5 at an odd head count (its
     one-head kernel) and on three causal queries, both timed at batch 1
     beside their bounds and checked in the TPU kernel's own function; the
     encoder attention's backward kernels K6 (dK, dV) and K7 (dQ) and K2's
     residual output in fp32 and bf16 (fp32 also at T=333, and the same
     bits over two launches), timed at the fine-tune's shape beside their
     tensor-core (bf16x3) and fp32 CUDA-core bounds, SDPA's fp32 forward
     and backward, and the split pass that K6 and K7 share; the int8
     self-cache's kernels: K4 in its int8 mode over caches K3 wrote (B=8,
     T=128, per-row lengths; B=1, T=448; S=3 causal), each held to itself
     over two launches and timed at B=8 and B=1, and K3 at the write's
     shape ([8, 1, 1280] and [1, 1, 1280] K and V), bit for bit, timed;
     K4's beam mode (the grouped beam step's self-attention, K=5) under
     random-parent ancestry masks at G=4, T=128 and G=1, T=448, on bf16
     caches and on int8 self-caches K3 wrote, against the plain version
     and itself over two launches, timed beside SDPA with the boolean mask
     and two bounds (the visible keys, all K*T keys); K4 and K5 at the
     speculative verify pass's shapes: K4 causal at per-row lengths, S=4 at
     B=8 over 144 rows (bf16 and int8 self-cache), S=5 at B=1 over 128 and
     512 rows; K5 with S=4 (B=8) and S=5 (B=1) queries a row on the int8
     cross-KV and the one-shot draft's S=1 step on a bf16 one; each against
     the plain version and itself, timed cold beside its bound and SDPA;
     K5's multi-query mode (a cluster per row for its S queries) at the
     beam server's G=4/S=5, the one-shot beam's G=1/S=5 and both verify
     shapes, on bf16 K/V, at S=13 (blocks walked) and 5 heads: against the
     plain version, against S launches of one query each (bit for bit) and
     itself, the four int8 shapes timed beside their bound and the
     per-query grid's time;
     the audio front's three recurrences (csrc/dsp.cu): the compressor's
     envelope and the limiter's gain on one 30 s window and on a 5 s
     chunk, the Wiener denoiser's noise floor on [3000, 22], each the plain
     version's bits and its own over two launches, timed beside two bounds
     (bytes at 3.35 TB/s; its dependent chain at 1.98 GHz); K1, K2 (bf16),
     K4 and K5 at the daemon's shapes (audio_ctx 256 and 512: 2T mel
     frames, T keys, 8 slots), timed beside their bounds and SDPA; the int8
     decoder weights' product (csrc/w8a16.cu, W8A16) at 1, 5, 8, 20, 32,
     448, 1500 and 12000 rows on large-v3's [1280, 1280], [1280, 5120] and
     [5120, 1280] and a tensor-parallel rank's [1280, 640] in bf16 (the q
     projection's bias folded on [1280, 1280]), at 1 and 8 rows in fp32:
     the kernel and the plain version within the tolerance helper's bound
     of the fp32 product, the kernel's bits the same over two launches,
     timed cold beside the plain version, the cast-plus-mm pair, the
     bound and, where the card's torch has it, _weight_int8pack_mm;
  3. a small-input reference check: the "tiny" model in fp32 on the card
     (kernels) against the same weights on the CPU (plain versions); then
     an EngineServer on the card (three windows over two slots, t=0)
     against the one-shot greedy loop on the card: the same tokens; then
     3 train_steps of "tiny" on the card against the CPU (losses and the
     first step's gradients); then "tiny" with all three int8 rungs on, the
     card against the CPU: quantized weights, W8A8 features, decoder
     logits and written self-cache over a prefill and 8 steps, and an
     int8-self-cache server's tokens; then "tiny" beam search (K=5): the
     one-shot beam's tokens card against CPU, the grouped beam step
     against the gather oracle on the card over random parents, and
     decode(cross_group=5) against the K-tiled cross-KV; then "tiny"
     speculative decoding (a random 1-layer draft, and tiny as its own
     draft): the one-shot loop's tokens card against CPU and against the
     card's greedy loop, and a spec server's tokens against a plain
     server's on the card;
  4. the one-shot path: WhisperEngine("large-v3", bf16, random weights from
     seed 0) transcribes two requests (about 20 s and 45 s of speech-like
     audio), with every kernel's launch count read over exactly that run;
     then one window's greedy decode under torch.profiler (host wall per
     decoder call, device busy time and idle share, top kernels);
  4c. the serving path: make_server with 8 slots on the same weights and
     longform.transcribe_files on 8 requests of 5-45 s, with every
     kernel's launch count read over exactly that run, then a few steps at
     8 busy slots under a device-only trace;
  4c-audio. the daemon's audio front on the same weights: build_preprocess
     (the default AudioConfig on one 30 s window, and every stage on over
     two consecutive 15 s ones), card against CPU (plain versions);
     make_server with the preprocess (every stage on) on 4 requests of
     5-30 s, the DSP kernels counted once a window, no "preprocess failed"
     warning, tokens equal to a plain server's fed the preprocessed audio;
     the VAD engines (energy, gru, Silero) into VadState and the wake-word
     detector on 45 s of speech-like audio with silences, card against
     CPU; host wall and device time per VAD chunk, wake-word chunk, 30 s
     preprocess and rnn_gains on 500 frames;
  4d. the int8 rungs on the same weights: WhisperEngine(quantize_weights,
     quantize_encoder) through phase 4's 20 s request (the W8A16 kernel
     counted: 8 launches a decoder layer a flat call or long prefill, 2 a
     layer a cross-KV) and 4b's trace (a decoder call's device and host
     time and the request's x-realtime beside phase 4's bf16 ones), the
     encoder's device time W8A8 against bf16 at B=1 and B=8 (and
     torch._int_mm on column- and row-major levels), then phase 4c's run
     on a server with an int8 self-cache (K3 counted once per layer and
     flat decoder call besides the cross-KV's), its self-cache bytes
     against bf16;
  4e. beam search on the bf16 weights (K=5): the one-shot engine with
     beam_size=5 on the 20 s request (the T=0 rung alone), one window's
     beam decode on the host clock and traced, then
     longform.make_server(beam_size=5) with 4 groups on 4 requests of
     5-45 s, bf16 and int8 self-cache, each with its launch counts held
     (K4's beam mode = 32 x grouped beam steps), state_bytes beside the
     allocation and 4 busy groups traced; last, a 1-group server's tokens
     on one window against the one-shot beam's on its cross-KV;
  4f. speculative decoding on the bf16 weights with a large-v3-turbo-shaped
     draft (random weights seeded 1): the one-shot engine on the 20 s
     request (the T=0 rung alone), its launch counts held to both models'
     layers; a draft call, a verify call and a greedy step timed on the
     host clock and traced; greedy, the draft and the self-draft on one
     window, tokens held to greedy's up to the first near-tie (4x the
     measured verify-vs-step logit error); a 1-slot spec server with the
     draft, with spec_force_accept and on the int8 self-cache, state_bytes
     beside the allocation, launch counts held, tokens held to a plain
     server's up to the same tie margin;
  4g. draft distillation on the bf16 weights: training/distill.py's
     distill_draft of a large-v3-turbo-shaped draft (4 decoder layers, d
     1280) on 8 rollout batches (and a held-out one) of 8 varied
     speech-like windows x 48 tokens, 6 epochs, under a time budget, with
     K1-K5's launches over exactly that run held to the rollouts' encodes,
     cross-KVs and flat decoder calls; then the distilled draft (and the
     engine's random one beside it) in the one-shot speculative loop on
     two held-out windows, tokens held to greedy's up to the first
     near-tie (phase 4f's margin), and in a 1-slot spec server against a
     plain server: tokens a verify;
  5. the CLI in subprocesses, four at once: `python -m
     openhush_tpu_torch.cli transcribe <wav> --model large-v3 --random-init
     --format json`, the same with `--beam-size 5` and with `--draft
     large-v3-turbo`, and with three WAVs (the serving path: a JSON list);
  6. the training path: `finetune` on large-v3 in fp32 (random weights from
     seed 0) over two synthetic WAVs, 5 steps, with the launch counts of the
     encoder attention's forward in residual mode (K2) and of its backward
     kernels (K6, K7) read over exactly that run;
  7. the ONNX executor (models/onnx2torch.py): a Silero-v5-signature
     graph and openWakeWord's two stages at their I/O widths, written by
     the phase with random weights, through vad.create_engine
     (OnnxSileroVad on the card) and WakeWordDetector.from_onnx, card
     against CPU, host wall and device busy per chunk;
  8. diarization: DiarizationEngine.from_local() (the packaged
     checkpoints) on 45 s of two synthetic speakers in 5 s chunks, card
     against CPU (embeddings, segments, speakers), host wall per chunk, DER
     on three synthetic meetings (card equal to CPU), and 50
     train_embedder steps on the card (the loss falls);
  9. M2M-100 418M at its published widths (random weights, fp32):
     greedy_translate of 2 rows of 32 source tokens to 256 tokens, the
     first row's first 16 tokens against the CPU's, wall per token, host
     wall and device busy per decode step, peak memory;
  10. the dictation daemon: `_build_daemon()` from a config file with
     model = "large-v3" (random weights, audio_ctx 512, warmup) and the
     REST API on 127.0.0.1 at a free port with an API key, driven on a
     thread with a real-time FileSource: three push-to-talk cycles of 3, 5
     and 8 s over its IPC socket, one over HTTP (POST start and stop; then GET
     status: queue_depth 0, preprocess_failures 0; a 401 without the key),
     one over D-Bus on a private session bus where dbus-daemon is on PATH
     (StartRecording, StopRecording, two IsRecordingChanged signals,
     GetStatus; else one line says that this drive did not run), F2's
     pair (a second press 0.1 s after a release while its final window
     decodes: both texts out in order, 0 pending) and 30 s of continuous
     dictation, under a device-only trace (per window: submit-to-text
     latency, tokens, steps; stop-to-final p50 and p90; busy share), each
     window's text held to a plain EngineServer's, preprocess_failures 0,
     then unload_model (memory back) and load_model (timed); then `python
     -m openhush_tpu_torch.cli start --no-tray` with model = "large-v3"
     (random weights, no warmup) driven by `status`, `recording
     start|stop` (one window transcribed) and `stop`;
  11. `record` on the card: `python -m openhush_tpu_torch.cli record
     --source file:<wav> --format srt --diarize --model large-v3 -o <srt>`
     in a subprocess on phase 8's 45 s of two synthetic speakers (random
     weights, a word vocabulary, no --max-duration): it exits 0 by itself
     within a deadline with its engine on CUDA, its 10 windows' texts
     equal a plain in-process EngineServer's on the same chunk cut (in its
     prep batches) and its speakers the in-process diarizer's dominant
     speakers; wall, audio seconds a wall second, each window's
     submit-to-result latency, the diarizer's host time a chunk, and an
     in-process repeat under a device-only trace (busy share, the
     diarizer's share of the loop, K1-K5 launches);
  12. convert and evaluate at large-v3-turbo's full width (random weights
     from SEED): the tree written as an HF-named fp16 model.safetensors
     with its config.json, `python -m openhush_tpu_torch.cli model convert
     large-v3-turbo --hf-path DIR` in a subprocess (the port's own reader
     reads the file; every npz leaf the fp16 source widened, bit for bit)
     and `model list`; a LibriSpeech-layout tree of 4 speech-like WAVs
     (5-12 s) through an in-process `evaluate_librispeech` on the npz
     (K1-K5 counted over that pass; its aggregate equal to wer.aggregate
     of its hypotheses), whose tokens equal an engine's on the source's
     fp16-rounded weights; two transcribes under utils/tracing.profile,
     whose Chrome trace names K1-K5; then, with those hypotheses as the
     tree's references, `evaluate --dataset TREE --model large-v3-turbo`
     in a subprocess (OPENHUSH_NO_FALLBACK=1: the t=0 rung), whose JSON
     must read WER 0 over all their words; and, beside
     `model convert`, `config show/set/get`, `secret set/get/delete`,
     `api-key generate`, `service status` and `device list --format json`
     in a home of their own;
  13. multi-device (openhush_tpu_torch.parallel), printing the card count
     and the backend: NCCL with a card a rank where there are enough
     cards, else gloo with every rank on the one card (CUDA tensors through
     the host), chosen explicitly; (a) dryrun_multichip(8): a 4x2 (data x
     model) mesh runs a sharded train step, encode and prefill, and greedy,
     speculative and beam batcher steps, the 1x2 and 2x2 sub-meshes the
     reduced pass, each held to a mesh of one rank on the same weights and
     inputs (tokens equal, losses and logits within 2e-4); (b) large-v3 at
     full width on a 1x2 mesh (10 heads a rank): 30 s of audio through K1,
     the encoder (K2), the int8 cross-KV (K3), a prefill and 32 greedy
     batcher steps (K4, K5), then one fp32 train step (K2 residual mode,
     K6, K7), against the same on one rank (rank 0 first, on the whole
     model): bf16 tokens equal up to the first near-tie (phase 4f's rule),
     loss within 2e-4, gradient norm within 1e-4 relative; then the same
     greedy run in fp32 (not counted), every token equal; per rank the
     K1-K7 launches (held to the layer counts), each stage's wall,
     all-reduces and their bytes, and peak memory;
then a `{"kernels": [...]}` line (launches from the serving path for K1-K5,
from the fine-tune for K6 and K7, from 4d's int8-self-cache server for K4's
int8 self-cache row and K3's write row, from 4e's bf16 beam server for K4's
beam-mode row and K5's multi-query row (with 4e's one-shot and int8 and
4f's verify launches of the mode beside), from 4f's one-shot speculative engine for the two verify
rows, from 4c-audio's preprocess server for the three DSP rows, from 4d's
one-shot int8 engine for the W8A16 row (its server's beside, every shape
of phase 2 under "shapes"); K1-K5 also
carry phase 4g's launches as distill_launches, phase 11's as
record_launches and phase 12's as evaluate_launches, K1-K5 and the limiter
phase 10's as daemon_launches, K1-K7 phase 13's per rank as
multichip_launches (K2's residual mode as multichip_residual_launches),
and K1, K2, K4 and K5 their daemon-shape measurements as ctx256_* and
ctx512_*) and, last, the
`{"ok": true, "device": ...}` line. Any failure raises, so the script
exits non-zero and prints no result. It never runs on the CPU: without CUDA
it exits 1 at once.
"""

import contextlib
import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
    time by kernel name, from the trace's raw events (the profiler's event
    tree takes minutes to build for a trace of a minute of serving)."""
    busy, by_name = 0.0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us = e.duration_ns() / 1e3
            busy += us
            by_name[e.name()] = by_name.get(e.name(), 0.0) + us
    return busy, by_name


def speechlike(secs: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.5 * t)
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def tone_over_silence(secs: float = 30.0) -> torch.Tensor:
    """A 440 Hz tone for the first half, then noise 90 dB below it: in the
    tone's frames the low mel bins lie up to 12 decades under the frame's
    peak, where the DFT's sums cancel."""
    g = torch.Generator().manual_seed(SEED + 5)
    t = torch.arange(int(16000 * secs)) / 16000
    x = 0.5 * torch.sin(2 * torch.pi * 440 * t)
    half = x.numel() // 2
    x[half:] = 1e-5 * torch.randn(x.numel() - half, generator=g)
    return x


def log_mel_energies_f64(mel, audio, n_mels: int, n_frames: int):
    """mel.log_mel_energies in float64 on the card: the bases and filter
    bank as stored (fp32), every sum in float64."""
    cos_b, sin_b = (torch.from_numpy(b).to(audio.device, torch.float64)
                    for b in mel._dft_bases())
    fb = torch.from_numpy(mel.mel_filter_bank(n_mels)).to(audio.device,
                                                          torch.float64)
    frames = mel.frame_signal(mel.reflect_pad(audio), n_frames).double()
    power = (frames @ cos_b) ** 2 + (frames @ sin_b) ** 2
    return torch.log10(torch.clamp(power @ fb, min=1e-10)).float()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_k1_energies(frontend, mel) -> None:
    """K1's log10 energies before the clamp (which the normalized check
    hides) against the plain version's at B=2, at 80 mels and at 1500
    frames (a reduced audio_ctx), and on a tone over near silence against
    float64 sums."""
    dev = torch.device("cuda")
    n_frames, n_mels = mel.N_FRAMES, 128
    # fp32 sums in two orders differ by up to ~1e-3 in bins 8 decades and
    # more under the window's peak.
    tol_e = 2e-3
    for B, nf, nm in ((2, n_frames, n_mels), (1, n_frames, 80),
                      (1, n_frames // 2, n_mels)):
        a = torch.cat([torch.from_numpy(speechlike(30.0, SEED + 30 + b))[None]
                       for b in range(B)]).to(dev)
        e = (frontend.log_mel_energies(a, nm, nf)
             - mel.log_mel_energies(a, nm, nf)).abs().max().item()
        log(f"  K1 log10 energies (before the clamp), B={B}, {nm} mels, {nf} "
            f"frames: max_abs_err {e:.3e} (tolerance {tol_e})")
        check(e <= tol_e, f"K1 energies B={B} mels={nm} frames={nf}")
    # A tone over near silence, against float64 sums: in every bin within 8
    # decades of its frame's peak (all of the quiet frames, whose every bin
    # the normalized check clamps). Deeper bins are fp32 rounding noise in
    # any order (up to 0.1 in log10 for the plain version too).
    tone = tone_over_silence()[None].to(dev)
    ref = log_mel_energies_f64(mel, tone, n_mels, n_frames)
    keep = ref > ref.amax(dim=-1, keepdim=True) - 8
    ours = frontend.log_mel_energies(tone, n_mels, n_frames)
    plain = mel.log_mel_energies(tone, n_mels, n_frames)
    e64, ep64, ep = ((x - y).abs()[keep].max().item()
                     for x, y in ((ours, ref), (plain, ref), (ours, plain)))
    log(f"  K1 tone over near silence, log10 energies within 8 decades of "
        f"the frame's peak ({int(keep.sum())} of {keep.numel()} bins): "
        f"kernel vs float64 {e64:.3e} (plain {ep64:.3e}; tolerance {tol_e}), "
        f"kernel vs plain {ep:.3e} (tolerance {1.5 * tol_e}); all bins "
        f"kernel vs plain {(ours - plain).abs().max().item():.3e}")
    check(e64 <= tol_e and ep <= 1.5 * tol_e, "K1 tone over near silence")


# K3's shapes besides the main path's: (dtype, B, T, heads, head_dim); a
# head of 32, 64 and 128 values fills 4, 8 and 16 lanes (bf16) or 8, 16 and
# 32 (fp32); one of 80 fills 10 lanes of 16 (bf16) or 20 of 32 (fp32).
K3_SHAPES = ((torch.float32, 2, 333, 20, 64), (torch.bfloat16, 2, 333, 2, 32),
             (torch.float32, 2, 333, 6, 128), (torch.bfloat16, 2, 333, 16, 128),
             (torch.bfloat16, 2, 333, 16, 80), (torch.float32, 2, 333, 16, 80))


def check_k3(quantize, k, v, n_head):
    """quantize_heads_kv of k and v into slice 1 of stacked [2, ...] buffers
    (slice 0 must stay as it was), and quantize_heads of k alone, against
    quantize_heads_plain: scales exact, int8 levels at most 1 apart on at
    most 1e-3 of the elements (.5 ties). Returns the K+V outputs (the
    slices) and the largest level error."""
    shape, dev = k.shape, k.device
    stacked = [torch.full((2, *shape), 7, dtype=torch.int8, device=dev),
               torch.full((2, *shape[:2], n_head), 7.0, device=dev),
               torch.full((2, *shape), 7, dtype=torch.int8, device=dev),
               torch.full((2, *shape[:2], n_head), 7.0, device=dev)]
    out = tuple(t[1] for t in stacked)
    quantize.quantize_heads_kv(k, v, n_head, out)
    one = quantize.quantize_heads(k, n_head)
    torch.cuda.synchronize()
    check(all(bool((t[0] == 7).all()) for t in stacked),
          "K3 K+V left the other layer's slice as it was")
    what = f"{k.dtype} {list(shape)}, {n_head} heads"
    err = 0
    for label, x, (q, s) in (("K", k, out[:2]), ("V", v, out[2:]),
                             ("one tensor", k, one)):
        qp, sp = quantize.quantize_heads_plain(x, n_head)
        s_err = (s - sp).abs().max().item()
        dq = (q.int() - qp.int()).abs()
        frac = dq.ne(0).float().mean().item()
        log(f"K3 quantize_heads{'' if label == 'one tensor' else '_kv'} "
            f"({label}, {what}): scales max_abs_err {s_err:.3e} (tolerance "
            f"0), int8 levels max_abs_err {dq.max().item()} on {frac:.2e} of "
            f"elements (tolerance 1 level on <= 1e-3: .5 ties)")
        check(s_err == 0 and dq.max().item() <= 1 and frac <= 1e-3,
              f"K3 quantize vs plain ({label}, {what})")
        err = max(err, dq.max().item())
    return out, err


def phase_kernels(frontend, flash_attention, quantize, mel):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    rows = []

    # K1: log-mel of one 30 s window, 128 mels (large-v3), fp32: the
    # normalized features, then the log10 energies before the clamp at B=2,
    # at 80 mels and at 1500 frames (a reduced audio_ctx).
    audio = torch.from_numpy(speechlike(30.0, SEED))[None].to(dev)
    n_frames, n_mels = mel.N_FRAMES, 128
    ours = frontend.log_mel(audio, n_mels)
    plain = mel.log_mel_spectrogram(audio, n_mels)
    torch.cuda.synchronize()
    err = (ours - plain).abs().max().item()
    tol = 1e-3   # normalized log-mel; fp32 sums in another order
    log(f"K1 log_mel: max_abs_err {err:.3e} (tolerance {tol})")
    check(err <= tol, "K1 log_mel vs plain")
    check_k1_energies(frontend, mel)
    # Bound: the DFT folded twice, by the sample symmetry (x[n] +- x[400-n]:
    # 201 samples a frame for re and for im) and by the bin symmetry
    # C[n, 200-k] = (-1)^n C[n, k] (each sample meets 101 bins: even and odd
    # n summed apart, then added and subtracted), plus the banded mel
    # projection (the filters' nonzeros). Beside it the bounds of the once
    # folded DFT the kernel runs (two [3000, 201] @ [201, 201] products) and
    # of the dense DFT. An FFT needs fewer operations still; there the bytes
    # would bound it.
    nnz = int(np.count_nonzero(mel.mel_filter_bank(n_mels)))
    n_bins = mel.N_FFT // 2 + 1
    mel_flops = 2 * n_frames * nnz
    nbytes = 4 * (audio.numel() + 2 * mel.N_FFT * n_bins + nnz
                  + n_frames * n_mels)
    b, by = bound_ms(nbytes, 2 * (2 * n_frames * n_bins * (n_bins // 2 + 1))
                     + mel_flops, "fp32")
    folded_b, _ = bound_ms(nbytes, 2 * (2 * n_frames * n_bins * n_bins)
                           + mel_flops, "fp32")
    dense_b, _ = bound_ms(nbytes, 2 * (2 * n_frames * mel.N_FFT * n_bins)
                          + mel_flops, "fp32")
    rows.append(dict(
        name="log_mel", source="openhush_tpu_torch/csrc/frontend.cu",
        replaces="openhush_tpu/ops/frontend_pallas.py:80",
        counter=frontend.log_mel_energies, max_abs_err=err,
        ms=time_ms(lambda: frontend.log_mel_energies(audio, n_mels, n_frames)),
        plain_ms=time_ms(lambda: mel.log_mel_energies(audio, n_mels, n_frames)),
        bound_ms=b, bound_by=by, folded_bound_ms=folded_b,
        dense_bound_ms=dense_b, library_ms=None))

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

    # K3: per-head int8 quantize of a layer's cross K and V, [1, 1500, 1280]
    # bf16 each, in one launch into a slice of stacked buffers, and of one
    # tensor alone; then fp32 and other head dims at T=333.
    k, v = ((scale * torch.randn(1, T, H * D, generator=g, device=dev)
             ).to(torch.bfloat16) for scale in (3.0, 1.0))
    out, err = check_k3(quantize, k, v, H)
    for dtype, Bq, Tq, Hq, Dq in K3_SHAPES:
        kq, vq = ((scale * torch.randn(Bq, Tq, Hq * Dq, generator=g,
                                       device=dev)).to(dtype)
                  for scale in (3.0, 1.0))
        check_k3(quantize, kq, vq, Hq)
    b, by = bound_ms(2 * (k.numel() * 2 + k.numel() + T * H * 4),
                     2 * 3 * k.numel(), "bf16")
    rows.append(dict(
        name="quantize_heads", source="openhush_tpu_torch/csrc/quantize_heads.cu",
        replaces="openhush_tpu/ops/quantize_pallas.py:56",
        counter=quantize.quantize_heads_kv, max_abs_err=float(err),
        ms=time_ms(lambda: quantize.quantize_heads_kv(k, v, H, out)),
        per_tensor_ms=time_ms(lambda: quantize.quantize_heads(k, H)),
        plain_ms=time_ms(
            lambda: quantize.quantize_heads_kv_plain(k, v, H, out)),
        bound_ms=b, bound_by=by, library_ms=None))
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"library {r['library_ms']}")
    return rows


# The DSP kernels' dependent chains: operations a step that wait on the
# step before, at ~4 cycles each: multiply, add, select for the envelope
# (both branches computed, the compare beside them) and the limiter; compare,
# select, multiply, add for the noise floor.
CHAIN_OPS = {"envelope": 3, "limiter_gain": 3, "noise_floor": 4}
CYCLES_PER_OP = 4
SM_HZ = 1.98e9                 # the H100's top SM clock


def time_once_ms(fn):
    """fn() once, timed by CUDA events (for plain versions that take
    seconds: a loop of launches the device waits on); returns (result,
    ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def chain_ms(name: str, steps: int) -> float:
    return steps * CHAIN_OPS[name] * CYCLES_PER_OP / SM_HZ * 1e3


def dsp_inputs(dsp, denoise, secs: float, seed: int):
    """The three recurrences' inputs as the path gives them, from one window
    of speech-like audio at 4x its level (so the limiter engages): the
    compressor's |x|, the limiter's target gains at -1 dB, the Wiener
    denoiser's log band energies [n_frames, 22] and its first floor."""
    dev = torch.device("cuda")
    x = 4.0 * torch.from_numpy(speechlike(secs, seed)).to(dev)
    n_frames = x.numel() // denoise.HOP
    pad = denoise.N_FFT // 2
    padded = torch.nn.functional.pad(x[None, None], (pad, pad),
                                     mode="reflect")[0, 0]
    re, im = denoise._stft(padded, n_frames)
    band = (re * re + im * im) @ denoise._bases(dev)["fb"]
    log_e = torch.log(band + 1e-10)
    return x.abs(), target_gains(dsp, x), log_e, log_e[0].clone()


def target_gains(dsp, x):
    """limit()'s target gains at -1 dB."""
    ceiling = dsp.fp32_scalar(10.0 ** (-1.0 / 20.0), x)
    return torch.where(x.abs() > ceiling,
                       ceiling / torch.clamp(x.abs(), min=1e-30),
                       dsp.fp32_scalar(1.0, x))


DSP_SEG = 512                                   # csrc/dsp.cu's SEG
DSP_WARM = {"envelope": 16, "limiter_gain": 8}  # its WARM, in segments


def dsp_hard_inputs(dsp, n: int, seed: int):
    """Inputs that keep the segment kernels' shortcuts from applying, each
    {kind: (target gains, magnitudes)} of n samples on the card: one peak
    then quiet, no peak, peaks on a segment's first sample and on the last,
    one peak every few segments, digital silence after speech, a constant,
    gains just under 1.0 (which leave the limiter on another fixed point
    below 1.0) with a few deep ones, +inf at a third and NaN at two thirds
    of speech."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    quiet = (0.02 * rng.standard_normal(n)).astype(np.float32)
    xs = {}
    x = quiet.copy()
    x[100] = 1.5
    xs["peak-then-quiet"] = x
    xs["no-peak"] = quiet
    x = quiet.copy()
    for i, v in ((0, 1.2), (DSP_SEG, 1.6), (17 * DSP_SEG, 1.3), (n - 1, 2.0)):
        if i < n:
            x[i] = v
    xs["peak-at-edges"] = x
    x = quiet.copy()
    x[150::5 * DSP_SEG + 13] = 1.4
    xs["sparse-peaks"] = x
    x = 4.0 * speechlike((n + 0.5) / 16000, seed + 1)
    x[n // 3:] = 0.0
    xs["silence-after-speech"] = x
    out = {}
    for kind, x in xs.items():
        t = torch.from_numpy(x).to(dev)
        out[kind] = (target_gains(dsp, t), t.abs())
    out["constant"] = (torch.full((n,), 0.7, device=dev),
                       torch.full((n,), 0.3, device=dev))
    tg = torch.ones(n, device=dev)
    tg[7::97] = 1.0 - 3e-6
    tg[500::733] = 0.6
    out["tg-under-1"] = (tg, torch.from_numpy(
        np.abs(speechlike((n + 0.5) / 16000, seed + 2))).to(dev))
    x = 4.0 * torch.from_numpy(speechlike((n + 0.5) / 16000, seed + 3)).to(dev)
    tg, a = target_gains(dsp, x), x.abs()
    for v in (tg, a):
        v[n // 3], v[2 * n // 3] = float("inf"), float("nan")
    out["non-finite"] = (tg, a)
    return out


def same_bits(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def phase_dsp_kernels(dsp, denoise):
    """The audio front's three recurrences (csrc/dsp.cu) against their plain
    versions on the card: the envelope and the limiter's gain on one 30 s
    window (480,000 samples) and on a 5 s daemon chunk, the noise floor on
    [3000, 22]. Each must give its plain version's bits (both round every
    product and sum on its own, in the reference's order) and its own bits
    over two launches. The envelope and the limiter's gain (segment walks
    with an exact carry) also on hard inputs (dsp_hard_inputs), bit for
    bit: at 3 s (48,037 samples, ragged and unaligned rows; each alone and
    all in one launch as signals of a batch) and at 300 samples against
    the plain version, at 30 s against the serial walk (oh_*_serial, the
    old design, fast enough to be the bit reference there). Timed by CUDA
    events beside the serial walk and two bounds: the bytes at 3.35 TB/s,
    and the walk the design cannot avoid ((WARM + 2) * SEG steps at the
    serial walk's time a step in this run); the serial chain at 1.98 GHz
    beside them."""
    att, rel = dsp.smoothing_coeff(5.0), dsp.smoothing_coeff(50.0)
    rc = dsp.smoothing_coeff(50.0)
    a30, tg30, le30, f30 = dsp_inputs(dsp, denoise, 30.0, SEED + 50)
    a5, tg5, le5, f5 = dsp_inputs(dsp, denoise, 5.0, SEED + 51)
    cases = {
        "envelope": (dsp.follow_envelope, dsp.follow_envelope_plain,
                     dsp.follow_envelope_serial, lambda a: (a, att, rel),
                     1, a30, a5,
                     "openhush_tpu/ops/dsp.py:39 _follow_envelope (lax.scan)"),
        "limiter_gain": (dsp.limiter_gain, dsp.limiter_gain_plain,
                         dsp.limiter_gain_serial, lambda t: (t, rc), 0,
                         tg30, tg5,
                         "openhush_tpu/ops/dsp.py:69 limit (its lax.scan "
                         "at :81)"),
    }
    hard = {n: dsp_hard_inputs(dsp, n, SEED + 52 + i)
            for i, n in enumerate((48037, 300, 480000))}

    def walk_bound(name, n, serial_ms):
        steps = min(n, (DSP_WARM[name] + 2) * DSP_SEG)
        return bound_ms(8 * n, 5 * n, "fp32")[0] + steps * serial_ms / n

    rows = []
    for name, (fn, plain, serial, args, which, x30, x5,
               replaces) in cases.items():
        row = dict(name=name, source="openhush_tpu_torch/csrc/dsp.cu",
                   replaces=replaces, counter=fn, library_ms=None)
        for label, x in (("", x30), ("chunk5s_", x5)):
            ours = fn(*args(x))
            again = fn(*args(x))
            ref, plain_ms = time_once_ms(lambda: plain(*args(x)))
            err = (ours - ref).abs().max().item()
            same = same_bits(ours, again)
            n = x.numel()
            b, by = bound_ms(8 * n, 5 * n, "fp32")
            chain = chain_ms(name, n)
            ms = time_ms(lambda: fn(*args(x)), iters=10, warmup=1)
            serial_ms = time_ms(lambda: serial(*args(x)), iters=5, warmup=1)
            walk = walk_bound(name, n, serial_ms)
            as_serial = same_bits(ours, serial(*args(x)))
            log(f"{name} ({n} samples): max_abs_err vs plain {err:.3e} "
                f"(tolerance 0: the same operations, each rounded), the same "
                f"bits over two launches: {same}, the serial walk's bits: "
                f"{as_serial}; kernel {ms:.4f} ms [serial walk "
                f"{serial_ms:.4f}], plain {plain_ms:.1f} ms; bounds: bytes "
                f"{b * 1e3:.2f} us, bytes and the walk {walk:.4f} ms; the "
                f"serial chain {chain:.4f} ms")
            check(err == 0 and same and as_serial
                  and bool(torch.isfinite(ours).all()),
                  f"{name} kernel vs plain on {n} samples")
            row.update({label + "max_abs_err": err, label + "ms": ms,
                        label + "plain_ms": plain_ms, label + "bound_ms": b,
                        label + "bound_by": by, label + "chain_bound_ms": chain,
                        label + "serial_ms": serial_ms,
                        label + "walk_bound_ms": walk})

        # The hard inputs: against the plain version at 48,037 and 300
        # samples (each alone, and all as one batch), against the serial
        # walk at 30 s.
        hard_ms = {}
        for n, inputs in hard.items():
            stack = torch.stack([v[which] for v in inputs.values()])
            against = plain if n < 480000 else serial
            ref = against(*args(stack))
            batch = fn(*args(stack))
            check(same_bits(batch, ref), f"{name} on the {len(inputs)} hard "
                  f"inputs of {n} samples as one batch")
            for i, (kind, v) in enumerate(inputs.items()):
                x = v[which]
                ours = fn(*args(x))
                again = fn(*args(x))
                ok = same_bits(ours, ref[i]) and same_bits(ours, again)
                err = (ours - ref[i]).abs().max().item()
                line = (f"{name}, {kind} ({n} samples): vs "
                        f"{'plain' if n < 480000 else 'the serial walk'} "
                        f"max_abs_err {err:.3e}, the same bits: {ok}")
                if n == 480000:
                    ms = time_ms(lambda: fn(*args(x)), iters=5, warmup=1)
                    serial_ms = time_ms(lambda: serial(*args(x)), iters=3,
                                        warmup=1)
                    hard_ms[kind] = [ms, serial_ms]
                    line += (f"; kernel {ms:.4f} ms [serial walk "
                             f"{serial_ms:.4f}]; bounds: bytes "
                             f"{bound_ms(8 * n, 5 * n, 'fp32')[0] * 1e3:.2f} "
                             f"us, bytes and the walk "
                             f"{walk_bound(name, n, serial_ms):.4f} ms")
                log(line)
                check(ok, f"{name} on {kind}, {n} samples, bit for bit")
        row["hard_inputs_ms"] = hard_ms
        rows.append(row)

    # The noise floor on a 30 s window's [3000, 22] log band energies.
    ours = denoise.noise_floor(le30, f30)
    again = denoise.noise_floor(le30, f30)
    ref, plain_ms = time_once_ms(lambda: denoise.noise_floor_plain(le30, f30))
    err = (ours - ref).abs().max().item()
    same = bool(torch.equal(ours, again))
    n = le30.numel()
    b, by = bound_ms(4 * (2 * n + f30.numel()), 5 * n, "fp32")
    chain = chain_ms("noise_floor", le30.shape[0])
    ms = time_ms(lambda: denoise.noise_floor(le30, f30))
    log(f"noise_floor ({list(le30.shape)}): max_abs_err vs plain {err:.3e} "
        f"(tolerance 0), the same bits over two launches: {same}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.1f} ms; bounds: bytes "
        f"{b * 1e3:.3f} us, the dependent chain {chain * 1e3:.2f} us (its "
        f"bound)")
    check(err == 0 and same, "noise_floor kernel vs plain")
    rows.append(dict(name="noise_floor", source="openhush_tpu_torch/csrc/dsp.cu",
                     replaces="openhush_tpu/ops/denoise.py:144 wiener_gains "
                     "(its lax.scan at :159)",
                     counter=denoise.noise_floor, max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     chain_bound_ms=chain, library_ms=None))
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


# The daemon's encoder contexts: audio_ctx for 2.5 s and 5 s chunks
# (runtime/daemon.audio_ctx_for: 256 is its least, 512 the random-init
# daemon's), each over 2 x audio_ctx mel frames.
DAEMON_CTXS = (256, 512)


def phase_daemon_shapes(frontend, flash_attention, da, quantize, mel):
    """K1, K2 (bf16), K4 and K5 at the daemon's shapes, large-v3's widths:
    for audio_ctx T in DAEMON_CTXS, K1 on one window of 2T frames (128
    mels), K2 at B=1 over T keys (the prep of one window), K4 on the bf16
    self-attention at 8 slots (causal, per-row lengths up to T) and K5 on
    the int8 cross-KV of T rows at 8 slots: each against its plain version
    (phase 2's tolerances), timed beside its bound and, for K2 and K4,
    SDPA. Returns {kernel name: {T: measurements}}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    B, H, D, n_mels = SERVE_SLOTS, 20, 64, 128
    HD = H * D
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = lambda x: x.view(x.shape[0], -1, H, D).transpose(1, 2)
    out = {name: {} for name in ("log_mel", "flash_attention",
                                 "decode_attention_direct",
                                 "decode_attention_pipelined")}
    nnz = int(np.count_nonzero(mel.mel_filter_bank(n_mels)))
    n_bins = mel.N_FFT // 2 + 1
    for T in DAEMON_CTXS:
        n_frames = 2 * T
        audio = torch.from_numpy(speechlike(n_frames * mel.HOP_LENGTH / 16000,
                                            SEED + T))[None].to(dev)
        ours = frontend.log_mel(audio, n_mels, n_frames)
        plain = mel.log_mel_spectrogram(audio, n_mels, n_frames)
        err = (ours - plain).abs().max().item()
        log(f"K1 log_mel at {n_frames} frames (audio_ctx {T}): max_abs_err "
            f"{err:.3e} (tolerance 1e-3)")
        check(err <= 1e-3 and ours.shape == (1, n_mels, n_frames),
              f"K1 log_mel vs plain at {n_frames} frames")
        b, by = bound_ms(4 * (audio.numel() + 2 * mel.N_FFT * n_bins + nnz
                              + n_frames * n_mels),
                         2 * (2 * n_frames * n_bins * (n_bins // 2 + 1))
                         + 2 * n_frames * nnz, "fp32")
        out["log_mel"][T] = dict(
            max_abs_err=err, bound_ms=b, bound_by=by, library_ms=None,
            ms=time_ms(lambda: frontend.log_mel_energies(audio, n_mels,
                                                         n_frames)),
            plain_ms=time_ms(lambda: mel.log_mel_energies(audio, n_mels,
                                                          n_frames)))

        qkv = [rnd(1, T, HD).to(torch.bfloat16).view(1, T, H, D)
               .transpose(1, 2) for _ in range(3)]
        ours = flash_attention.flash_attention(*qkv)
        plain = flash_attention.attend(*qkv)
        err = (ours.float() - plain.float()).abs().max().item()
        log(f"K2 flash_attention (bf16, B=1, T={T}): max_abs_err {err:.3e} "
            f"(tolerance 1e-2)")
        check(err <= 1e-2 and bool(torch.isfinite(ours).all()),
              f"K2 flash_attention vs plain at T={T}")
        b, by = bound_ms(4 * H * T * D * 2, 4 * H * T * T * D, "bf16")
        out["flash_attention"][T] = dict(
            max_abs_err=err, bound_ms=b, bound_by=by,
            ms=time_ms(lambda: flash_attention.flash_attention(*qkv)),
            plain_ms=time_ms(lambda: flash_attention.attend(*qkv)),
            library_ms=time_ms(lambda: sdpa(*qkv)))

        # K4: the self-attention step over T rows, bf16, causal, per-row
        # lengths; one cache copy per decoder layer, each launch on the next.
        q = rnd(B, 1, HD).to(torch.bfloat16)
        k, v = (rnd(B, T, HD).to(torch.bfloat16) for _ in range(2))
        lengths = (torch.randint(0, T, (B,), generator=g, device=dev)
                   + 1).to(torch.int32)
        args = (q, k, v, lengths, H)
        o4 = da.attend_decode(*args, causal=True)
        plain = da.attend_decode_plain(*args, causal=True)
        err = (o4.float() - plain.float()).abs().max().item()
        log(f"K4 attend_decode (bf16 self, B={B}, T={T}, causal, per-row "
            f"lengths): max_abs_err {err:.3e} (tolerance 1e-2)")
        check(err <= 1e-2, f"K4 bf16 self-attention vs plain at T={T}")
        n_keys = int(lengths.sum())
        b, by = bound_ms(2 * n_keys * HD * 2 + 2 * B * HD * 2 + 4 * B,
                         4 * n_keys * HD, "fp32")
        mask = (torch.arange(T, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        layers = [(k.clone(), v.clone()) for _ in range(N_LAYER)]
        on_layers = lambda fn: rotate([
            functools.partial(fn, q, kl, vl, lengths, H, causal=True)
            for kl, vl in layers])
        out["decode_attention_direct"][T] = dict(
            max_abs_err=err, bound_ms=b, bound_by=by,
            ms=time_ms(on_layers(da.attend_decode), iters=2 * N_LAYER),
            plain_ms=time_ms(on_layers(da.attend_decode_plain)),
            library_ms=time_ms(rotate([
                functools.partial(sdpa, heads(q), heads(kl), heads(vl),
                                  attn_mask=mask) for kl, vl in layers]),
                iters=2 * N_LAYER))
        del layers

        # K5: the cross-attention over the int8 cross-KV of T rows.
        (k8, ks), (v8, vs) = (quantize.quantize_heads_plain(
            rnd(B, T, HD).to(torch.bfloat16), H) for _ in range(2))
        o5, p5 = da.attend_decode_pipelined(q, k8, v8, None, H, ks=ks, vs=vs,
                                            return_probs=True)
        plain, p_plain = da.attend_decode_plain(q, k8, v8, None, H, ks=ks,
                                                vs=vs, return_probs=True)
        err = (o5.float() - plain.float()).abs().max().item()
        dp = (p5 - p_plain).abs()
        share = dp.ne(0).sum().item() / (H * B * T)
        log(f"K5 attend_decode_pipelined (int8 cross, B={B}, T={T}): "
            f"max_abs_err {err:.3e} (tolerance 1e-2); int8 prob levels max "
            f"diff {dp.max().item():.0f} on {share:.2e} of keys (tolerance "
            f"1 level on <= 1e-3)")
        check(err <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3,
              f"K5 int8 cross-attention vs plain at T={T}")
        b, by = bound_ms(2 * B * T * HD + 2 * B * T * H * 4 + 2 * B * HD * 2,
                         4 * B * T * HD, "fp32")
        layers = [tuple(x.clone() for x in (k8, v8, ks, vs))
                  for _ in range(N_LAYER)]
        on_layers = lambda fn: rotate([
            functools.partial(fn, q, kl, vl, None, H, ks=ksl, vs=vsl)
            for kl, vl, ksl, vsl in layers])
        out["decode_attention_pipelined"][T] = dict(
            max_abs_err=err, bound_ms=b, bound_by=by, library_ms=None,
            ms=time_ms(on_layers(da.attend_decode_pipelined),
                       iters=2 * N_LAYER),
            plain_ms=time_ms(on_layers(da.attend_decode_plain)))
        del layers
    for name, by_ctx in out.items():
        for T, r in by_ctx.items():
            log(f"  {name} at audio_ctx {T}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us "
                f"({r['bound_by']}), library {r['library_ms']}")
    return out


def phase_int8_self_cache(da, quantize):
    """The int8 self-cache's kernels at large-v3's width (20 heads, Dh 64):
    K4 in its int8 mode (kv_kind 0, causal, per-row lengths) over caches
    whose levels and scales K3 wrote from random bf16 keys, as the decode
    step writes them: B=8, T=128 (the serving step), B=1, T=448 with every
    row visible, and S=3 causal queries (a flat prefill); each against the
    plain version and against itself over two launches, then timed over 32
    per-layer copies (cold in L2) at B=8 and at B=1 (100 keys of 128, as
    the bf16 row). Then K3 at the write's shape: one launch for a layer's
    new K and V, [8, 1, 1280] and [1, 1, 1280] bf16, bit for bit against
    the plain version, timed."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    H, D = 20, 64
    HD = H * D
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)

    def empty_kv(B, T):
        return (torch.empty(B, T, HD, dtype=torch.int8, device=dev),
                torch.empty(B, T, H, device=dev),
                torch.empty(B, T, HD, dtype=torch.int8, device=dev),
                torch.empty(B, T, H, device=dev))

    def k3_cache(B, T):
        """(k8, v8, ks, vs): K3's levels and scales of random bf16 keys."""
        out = empty_kv(B, T)
        k, v = (rnd(B, T, HD).to(torch.bfloat16) for _ in range(2))
        quantize.quantize_heads_kv(k, v, H, out)
        return out[0], out[2], out[1], out[3]

    rows = []
    main = None
    for B, T, S, lengths in (
            (SERVE_SLOTS, 128, 1, (torch.randint(0, 128, (SERVE_SLOTS,),
                                                 generator=g, device=dev)
                                   + 1).to(torch.int32)),
            (1, 448, 1, torch.full((1,), 448, dtype=torch.int32,
                                   device=dev)),
            (2, 128, 3, torch.tensor([126, 9], dtype=torch.int32,
                                     device=dev))):
        k8, v8, ks, vs = k3_cache(B, T)
        q = rnd(B, S, HD).to(torch.bfloat16)
        args = (q, k8, v8, lengths, H)
        kw = dict(ks=ks, vs=vs, causal=True, return_probs=True)
        (o, p), (o2, p2) = (da.attend_decode(*args, **kw) for _ in range(2))
        plain, p_plain = da.attend_decode_plain(*args, **kw)
        torch.cuda.synchronize()
        what = f"B={B}, T={T}, S={S}"
        check(torch.equal(o, o2) and torch.equal(p, p2),
              f"K4 int8 self-cache ({what}): the same bits over two launches")
        e = (o.float() - plain.float()).abs().max().item()
        dp = (p - p_plain).abs()
        n_vis = H * sum(min(int(n) + s, T) for n in lengths for s in range(S))
        share = dp.ne(0).sum().item() / n_vis
        log(f"K4 attend_decode (int8 self-cache, {what}, causal, lengths "
            f"{lengths.tolist() if B <= 2 else 'per row'}): max_abs_err "
            f"{e:.3e} (tolerance 1e-2: bf16 outputs, and a prob level moved "
            f"at a .5 tie moves an output by at most max_t(p*vs)); int8 prob "
            f"levels max diff {dp.max().item():.0f} on {share:.2e} of "
            f"visible keys (tolerance 1 level on <= 1e-3); the same bits "
            f"over two launches")
        check(e <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3,
              f"K4 int8 self-cache vs plain ({what})")
        if main is None:
            main = (q, k8, v8, ks, vs, lengths, e)
    q, k8, v8, ks, vs, lengths, err = main
    B = q.shape[0]

    def bound(n_keys, nb):
        # The visible keys' int8 K and V (1280 B each) and their scales
        # (2 x 20 fp32), the bf16 query and output, the lengths.
        return bound_ms(n_keys * (2 * HD + 2 * H * 4) + 2 * nb * HD * 2
                        + 4 * nb, 4 * n_keys * HD, "fp32")

    b, by = bound(int(lengths.sum()), B)
    layers = [tuple(x.clone() for x in (k8, v8, ks, vs))
              for _ in range(N_LAYER)]
    on_layers = lambda fn, batch=slice(None), lens=lengths: rotate([
        functools.partial(fn, q[batch], kl[batch], vl[batch], lens, H,
                          ks=ksl[batch], vs=vsl[batch], causal=True)
        for kl, vl, ksl, vsl in layers])
    lens1 = torch.tensor([100], dtype=torch.int32, device=dev)
    rows.append(dict(
        name="decode_attention_direct_int8_self",
        source="openhush_tpu_torch/csrc/decode_attention.cu",
        replaces="openhush_tpu/ops/decode_attention.py:133",
        counter=da.attend_decode, max_abs_err=err,
        ms=time_ms(on_layers(da.attend_decode), iters=2 * N_LAYER),
        plain_ms=time_ms(on_layers(da.attend_decode_plain)),
        bound_ms=b, bound_by=by, library_ms=None,
        batch1_ms=time_ms(on_layers(da.attend_decode, slice(0, 1), lens1),
                          iters=2 * N_LAYER),
        batch1_bound_ms=bound(100, 1)[0]))
    del layers

    # K3 at the write's shape: a layer's S = 1 new K and V at 8 slots (the
    # serving step) and at batch 1.
    for nb in (SERVE_SLOTS, 1):
        k, v = (rnd(nb, 1, HD).to(torch.bfloat16) for _ in range(2))
        out, ref = empty_kv(nb, 1), empty_kv(nb, 1)
        quantize.quantize_heads_kv(k, v, H, out)
        quantize.quantize_heads_kv_plain(k, v, H, ref)
        torch.cuda.synchronize()
        check(all(torch.equal(a, r) for a, r in zip(out, ref)),
              f"K3 at the write's shape [{nb}, 1, {HD}]: the plain "
              f"version's bits")
        log(f"K3 quantize_heads_kv (self-cache write, [{nb}, 1, {HD}] bf16 "
            f"K and V in one launch): levels and scales the plain "
            f"version's bits")
        ms = time_ms(lambda: quantize.quantize_heads_kv(k, v, H, out))
        # Both inputs read once, both outputs' levels and scales written.
        nb_bound = bound_ms(2 * (nb * HD * 2 + nb * HD + nb * H * 4),
                            2 * 3 * nb * HD, "bf16")
        if nb == SERVE_SLOTS:
            rows.append(dict(
                name="quantize_heads_self_write",
                source="openhush_tpu_torch/csrc/quantize_heads.cu",
                replaces="openhush_tpu/ops/quantize_pallas.py:56",
                counter=quantize.quantize_heads_kv, max_abs_err=0.0, ms=ms,
                plain_ms=time_ms(lambda: quantize.quantize_heads_kv_plain(
                    k, v, H, ref)),
                bound_ms=nb_bound[0], bound_by=nb_bound[1], library_ms=None))
        else:
            rows[-1]["batch1_ms"] = ms
            rows[-1]["batch1_bound_ms"] = nb_bound[0]
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.3f} us "
            f"({r['bound_by']}); batch 1: kernel {r['batch1_ms']:.4f} ms, "
            f"bound {r['batch1_bound_ms'] * 1e3:.3f} us; library none (no "
            f"one PyTorch call does the int8 math)")
    return rows


K_SPEC = 4                   # the server's block (EngineServer's k_spec)
K_ONESHOT = 5                # the one-shot engine's (decode_speculative)
SPEC_T = 128 + 16            # a spec server's rows: max_decode_len + margin


def phase_spec_attention(da, quantize):
    """K4 and K5 at the speculative verify pass's shapes (large-v3, 20
    heads, Dh 64), each against the plain version and against itself over
    two launches, then timed cold (32 per-layer copies) beside its bound
    (the visible keys' bytes) and, where one exists, SDPA's time. K4: the
    verify's self-attention, causal at per-row lengths (query s of row b
    sees fill_b + 1 + s keys): S=4 at B=8 over SPEC_T = 144 rows (the spec
    server's block, bf16 and the int8 self-cache K3 wrote), S=5 at B=1 over
    128 rows (the one-shot block) and over 512 (the one-shot cache past
    n_text_ctx: a 228-token prompt and 219 new tokens). K5: the verify's
    cross-attention with S queries a row over the int8 cross-KV (T=1500; S=4
    at B=8, S=5 at B=1), and the one-shot draft's S=1 step over its bf16
    cross-KV."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    H, D = 20, 64
    HD = H * D
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def k3_cache(B, T):
        out = tuple(torch.empty(B, T, *s, dtype=dt, device=dev) for s, dt in (
            ((HD,), torch.int8), ((H,), torch.float32), ((HD,), torch.int8),
            ((H,), torch.float32)))
        k, v = (rnd(B, T, HD).to(torch.bfloat16) for _ in range(2))
        quantize.quantize_heads_kv(k, v, H, out)
        return out[0], out[2], out[1], out[3]

    def held(what, fn, q, kv, lengths, causal, n_vis):
        """fn against the plain version (1e-2 on the bf16 outputs; int8: an
        int8 prob level within 1 on <= 1e-3 of the visible keys) and
        against itself over two launches; returns the max abs error."""
        k, v, ks, vs = kv
        kw = dict(ks=ks, vs=vs, causal=causal, return_probs=True)
        (o, p), (o2, p2) = (fn(q, k, v, lengths, H, **kw) for _ in range(2))
        plain, p_plain = da.attend_decode_plain(q, k, v, lengths, H, **kw)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and torch.equal(p, p2),
              f"{what}: the same bits over two launches")
        e = (o.float() - plain.float()).abs().max().item()
        dp = (p - p_plain).abs()
        if ks is not None:
            share = dp.ne(0).sum().item() / n_vis
            log(f"{what}: max_abs_err {e:.3e} (tolerance 1e-2), int8 prob "
                f"levels max diff {dp.max().item():.0f} on {share:.2e} of "
                f"visible keys (tolerance 1 level on <= 1e-3); the same "
                f"bits over two launches")
            check(e <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3,
                  f"{what} vs plain")
        else:
            log(f"{what}: max_abs_err {e:.3e} (tolerance 1e-2: bf16 "
                f"outputs), probs max_abs_err {dp.max().item():.3e}; the "
                f"same bits over two launches")
            check(e <= 1e-2, f"{what} vs plain")
        return e

    def timings(fn, q, kv, lengths, causal, mask=None):
        """(kernel, plain, SDPA or None) ms over 32 per-layer copies."""
        layers = [tuple(None if x is None else x.clone() for x in kv)
                  for _ in range(N_LAYER)]
        B = q.shape[0]
        run = lambda f: rotate([functools.partial(
            f, q, k, v, lengths, H, ks=ks, vs=vs, causal=causal)
            for k, v, ks, vs in layers])
        heads = lambda x: x.view(B, -1, H, D).transpose(1, 2)
        lib = None
        if kv[2] is None:
            lib = time_ms(rotate([functools.partial(
                sdpa, heads(q), heads(k), heads(v), attn_mask=mask)
                for k, v, _, _ in layers]), iters=2 * N_LAYER)
        return (time_ms(run(fn), iters=2 * N_LAYER),
                time_ms(run(da.attend_decode_plain)), lib)

    # K4: the verify's self-attention.
    rows = []
    k4 = dict(name="decode_attention_direct_verify",
              source="openhush_tpu_torch/csrc/decode_attention.cu",
              replaces="openhush_tpu/ops/decode_attention.py:133",
              counter=da.attend_decode)
    serve_fills = torch.randint(1, 127, (SERVE_SLOTS,), generator=g,
                                device=dev)
    for pre, B, S, T, fills, int8 in (
            ("", SERVE_SLOTS, K_SPEC, SPEC_T, serve_fills, False),
            ("int8_", SERVE_SLOTS, K_SPEC, SPEC_T, serve_fills, True),
            ("oneshot_", 1, K_ONESHOT, 128, torch.tensor([100], device=dev),
             False),
            ("t512_", 1, K_ONESHOT, 512, torch.tensor([446], device=dev),
             False)):
        lengths = (fills + 1).to(torch.int32)
        q = rnd(B, S, HD).to(torch.bfloat16)
        kv = (k3_cache(B, T) if int8 else tuple(
            rnd(B, T, HD).to(torch.bfloat16) for _ in range(2)) + (None, None))
        vis = [min(int(n) + s, T) for n in lengths for s in range(S)]
        cache = "int8 self-cache" if int8 else "bf16"
        rows_at = fills.tolist() if B == 1 else "per row"
        what = (f"K4 attend_decode (verify: {cache}, B={B}, S={S} causal, "
                f"T={T}, fills {rows_at})")
        e = held(what, da.attend_decode, q, kv, lengths, True, H * sum(vis))
        # Each visible key read once: the block's last query sees them all.
        n_read = sum(min(int(n) + S - 1, T) for n in lengths)
        key_bytes = 2 * HD + 2 * H * 4 if int8 else 2 * HD * 2
        b, by = bound_ms(n_read * key_bytes + 2 * B * S * HD * 2 + 4 * B,
                         4 * sum(vis) * HD, "fp32")
        mask = (torch.arange(T, device=dev)[None, None, :]
                < (lengths[:, None, None] + torch.arange(S, device=dev)[
                    None, :, None]))[:, None]
        ms, plain_ms, lib = timings(da.attend_decode, q, kv, lengths, True,
                                    mask)
        k4.update({pre + "ms": ms, pre + "plain_ms": plain_ms,
                   pre + "bound_ms": b, pre + "library_ms": lib})
        if pre == "":
            k4.update(max_abs_err=e, bound_by=by)
        label = pre.rstrip("_") or "serving"
        log(f"  {label} verify K4: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b * 1e3:.3f} us ({by}), SDPA {lib}")
    rows.append(k4)

    # K5: the verify's cross-attention (int8), the one-shot draft's (bf16).
    k5 = dict(name="decode_attention_pipelined_verify",
              source="openhush_tpu_torch/csrc/decode_attention.cu",
              replaces="openhush_tpu/ops/decode_attention_dma.py:101",
              counter=da.attend_decode_pipelined)
    T = 1500
    for pre, B, S, int8 in (("", SERVE_SLOTS, K_SPEC, True),
                            ("oneshot_", 1, K_ONESHOT, True),
                            ("draft_bf16_", 1, 1, False)):
        q = rnd(B, S, HD).to(torch.bfloat16)
        kv = (k3_cache(B, T) if int8 else tuple(
            rnd(B, T, HD).to(torch.bfloat16) for _ in range(2)) + (None, None))
        role = "verify, int8" if int8 else "one-shot draft step, bf16"
        what = (f"K5 attend_decode_pipelined ({role} cross-KV, B={B}, "
                f"S={S}, T={T})")
        e = held(what, da.attend_decode_pipelined, q, kv, None, False,
                 H * B * S * T)
        esize = 1 if int8 else 2
        b, by = bound_ms(2 * B * T * HD * esize + (2 * B * T * H * 4 if int8
                                                   else 0)
                         + 2 * B * S * HD * 2, 4 * B * S * T * HD, "fp32")
        ms, plain_ms, lib = timings(da.attend_decode_pipelined, q, kv, None,
                                    False)
        k5.update({pre + "ms": ms, pre + "plain_ms": plain_ms,
                   pre + "bound_ms": b, pre + "library_ms": lib})
        if pre == "":
            k5.update(max_abs_err=e, bound_by=by)
        label = pre.rstrip("_") or "serving"
        log(f"  {label} K5: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b * 1e3:.3f} us ({by}), SDPA {lib}")
    rows.append(k5)
    return rows


def multi_held(da, what, q, kv, lengths, H):
    """K5's multi-query mode (`attend_decode_multi`) on one shape: within
    the plain version's tolerance (1e-2 on the outputs; int8: a prob level
    within 1 on <= 1e-3 of the visible keys, as phase 2's K5 rows), the
    same bits over two launches, and each query's output and probs equal,
    bit for bit, to a K5 launch of that query alone (S=1). Returns the max
    abs error against the plain version."""
    k, v, ks, vs = kv
    B, S, _ = q.shape
    T = k.shape[1]
    kw = dict(ks=ks, vs=vs, return_probs=True)
    (o, p), (o2, p2) = (da.attend_decode_multi(q, k, v, lengths, H, **kw)
                        for _ in range(2))
    alone = [da.attend_decode_pipelined(q[:, s:s + 1].contiguous(), k, v,
                                        lengths, H, **kw) for s in range(S)]
    plain, p_plain = da.attend_decode_plain(q, k, v, lengths, H, **kw)
    torch.cuda.synchronize()
    check(torch.equal(o, o2) and torch.equal(p, p2),
          f"{what}: the same bits over two launches")
    same = (torch.equal(o, torch.cat([a[0] for a in alone], 1))
            and torch.equal(p, torch.cat([a[1] for a in alone], 1)))
    e = (o.float() - plain.float()).abs().max().item()
    dp = (p - p_plain).abs()
    n = B * T if lengths is None else int(lengths.clamp(max=T).sum())
    share = dp.ne(0).sum().item() / (H * S * n)
    int8 = ks is not None
    log(f"{what}: max_abs_err {e:.3e} (tolerance 1e-2), "
        + (f"int8 prob levels max diff {dp.max().item():.0f} on {share:.2e} "
           f"of visible keys (tolerance 1 level on <= 1e-3)" if int8 else
           f"probs max_abs_err {dp.max().item():.3e}")
        + f"; each query {'equal' if same else 'NOT equal'} bit for bit to "
        f"a launch of it alone; the same bits over two launches")
    check(same, f"{what}: each query's output and probs == a K5 launch of "
          f"that query alone")
    check(e <= 1e-2 and (not int8 or (dp.max().item() <= 1
                                      and share <= 1e-3)),
          f"{what} vs plain")
    return e


def phase_multi_attention(da, quantize):
    """K5's multi-query mode (one cluster per (pair of heads, row) for the
    row's S queries, causal off) at large-v3's widths (20 heads, Dh 64)
    over the int8 cross-KV of T = 1500 rows, every key visible: a 4-group
    beam server's step (G=4 rows of K=5 beams folded, S=5), the one-shot
    beam (G=1, S=5), the spec server's verify (B=8, S=4) and the one-shot
    verify (B=1, S=5), each through multi_held and timed cold over 32
    per-layer copies beside its bound (bytes), the plain version's time
    and the per-query grid's on the same inputs (K5 before this mode: a
    cluster per query, each reading the row's keys); also through
    multi_held bf16 K/V (B=1, S=5), 13 queries a row (blocks of S_MAX
    walked over one slice) at B=3 with per-row lengths 1499, 700 and 1 and
    at B=1 (a thread group a query), and 5 heads (one head a cluster,
    S=6). Returns the `{"kernels"}` row of the mode."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    H, D, T = 20, 64, 1500
    HD = H * D
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)

    def int8_kv(B, T=T, H=H):
        (k8, ks), (v8, vs) = (quantize.quantize_heads_plain(
            rnd(B, T, H * D).to(torch.bfloat16), H) for _ in range(2))
        return k8, v8, ks, vs

    def per_query(q, k, v, lengths, n_head, ks=None, vs=None):
        return da._attend(q, k, v, lengths, n_head, ks, vs, False, 1,
                          "K5 per query", False)

    def timed(fn, q, kv):
        layers = [tuple(x.clone() for x in kv) for _ in range(N_LAYER)]
        return time_ms(rotate([functools.partial(
            fn, q, k, v, None, H, ks=ks, vs=vs) for k, v, ks, vs in layers]),
            iters=2 * N_LAYER)

    row = dict(name="decode_attention_multi",
               source="openhush_tpu_torch/csrc/decode_attention.cu",
               replaces="openhush_tpu/ops/decode_attention_dma.py:101",
               counter=da.attend_decode_multi, library_ms=None)
    for pre, what, B, S in (("", "beam server, G=4 groups of K=5", 4, 5),
                            ("g1_", "one-shot beam, G=1", 1, 5),
                            ("spec8_", "spec server verify", SERVE_SLOTS,
                             K_SPEC),
                            ("spec1_", "one-shot verify", 1, K_ONESHOT)):
        q = rnd(B, S, HD).to(torch.bfloat16)
        kv = int8_kv(B)
        e = multi_held(da, f"K5 multi-query ({what}: B={B}, S={S}, int8 "
                       f"cross-KV, T={T})", q, kv, None, H)
        b, by = bound_ms(2 * B * T * HD + 2 * B * T * H * 4
                         + 2 * B * S * HD * 2, 4 * B * S * T * HD, "fp32")
        ms = timed(da.attend_decode_multi, q, kv)
        old = timed(per_query, q, kv)
        plain = time_ms(rotate([functools.partial(
            da.attend_decode_plain, q, *kv[:2], None, H, ks=kv[2],
            vs=kv[3])]))
        row.update({pre + "max_abs_err": e, pre + "ms": ms,
                    pre + "plain_ms": plain, pre + "bound_ms": b,
                    pre + "per_query_ms": old})
        if pre == "":
            row["bound_by"] = by
        log(f"  K5 multi-query, {what} (B={B}, S={S}): kernel {ms:.4f} ms, "
            f"the per-query grid {old:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b * 1e3:.3f} us ({by})")
    q = rnd(1, 5, HD).to(torch.bfloat16)
    multi_held(da, "K5 multi-query (bf16 cross-KV, B=1, S=5, T=1500)", q,
               tuple(rnd(1, T, HD).to(torch.bfloat16) for _ in range(2))
               + (None, None), None, H)
    for B, lens in ((3, [T - 1, 700, 1]), (1, [T - 3])):
        q = rnd(B, 13, HD).to(torch.bfloat16)
        multi_held(da, f"K5 multi-query (int8, B={B}, S=13: blocks of "
                   f"{da.S_MAX} walked, lengths {lens})", q, int8_kv(B),
                   torch.tensor(lens, dtype=torch.int32, device=dev), H)
    q = rnd(2, 6, 5 * D).to(torch.bfloat16)
    multi_held(da, "K5 multi-query (int8, 5 heads: one a cluster, B=2, "
               "S=6)", q, int8_kv(2, H=5), None, 5)
    return row


# The W8A16 phase: rows of x (one-shot 1, one-shot beam 5, serving 8, a
# 4-group beam server 20, the spec server's verify 32, a 448-token block,
# one window's cross-KV 1500 and eight windows' 12000), at large-v3's
# decoder widths and a tensor-parallel rank's [1280, 640]; fp32 x (the tiny
# model's path) at 1 and 8 rows.
W8A16_MS = (1, 5, 8, 20, 32, 448, 1500, 12000)
W8A16_FP32_MS = (1, 8)
W8A16_SHAPES = ((1280, 1280), (1280, 5120), (5120, 1280), (1280, 640))


def phase_w8a16(w8a16, whisper):
    """The int8 decoder weights' product (csrc/w8a16.cu) at every W8A16_MS
    row count on each of W8A16_SHAPES in bf16, and at W8A16_FP32_MS in fp32,
    on levels and scales from the port's own recipe (model._quantize_weight
    of random weights), with the q projection's bias folded on [1280, 1280]:
    the kernel and the plain version each within the tolerance helper's
    bound of the fp32 reference (w8a16.within_tolerance), the kernel's
    outputs the same bits over two launches; timed over enough per-layer
    copies of the levels to exceed the 50 MB L2 (a decoder call reads each
    once), beside the plain version, the library pair (the levels cast to
    x's dtype and torch.mm with fp32 output, as the port ran it before this
    kernel) and, where the card's torch has one, torch._weight_int8pack_mm
    on a transposed copy at the decode shapes, M <= 32 (its bf16 scales
    round otherwise: timed, not checked; a yardstick the card's torch may
    lack, so a refusal only drops its column). Returns the `{"kernels"}`
    row (the one-shot's M=1 on [1280, 1280] in its main keys, every shape
    under "shapes")."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 120)
    torch.backends.cuda.matmul.allow_tf32 = False
    pack = getattr(torch, "_weight_int8pack_mm", None)
    row = dict(name="w8a16", source="openhush_tpu_torch/csrc/w8a16.cu",
               replaces="openhush_tpu/models/whisper/model.py:274 _mm",
               counter=w8a16.mm_w8a16, shapes=[])
    for I, O in W8A16_SHAPES:
        ws = [whisper._quantize_weight(0.05 * torch.randn(
            I, O, generator=g, device=dev))
            for _ in range(max(2, math.ceil(64e6 / (I * O))))]
        bias = 0.5 * torch.randn(O, generator=g, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            for M in (W8A16_MS if dtype == torch.bfloat16 else W8A16_FP32_MS):
                x = torch.randn(M, I, generator=g, device=dev).to(dtype)
                b = bias.to(dtype) if (I, O) == (1280, 1280) else None
                w = ws[0]
                y = w8a16.mm_w8a16(x, w, b)
                again = w8a16.mm_w8a16(x, w, b)
                plain = w8a16.mm_w8a16_plain(x, w, b)
                torch.cuda.synchronize()
                ok, ratio = w8a16.within_tolerance(y, x, w, b)
                ok_p, ratio_p = w8a16.within_tolerance(plain, x, w, b)
                err = (y.float() - plain.float()).abs().max().item()
                differ = (y != plain).float().mean().item()
                what = (f"W8A16 [{M}, {I}] x [{I}, {O}] "
                        f"{str(dtype)[6:]}" + (" + bias" if b is not None
                                               else ""))
                log(f"  {what}: vs the fp32 reference at most {ratio:.3f} "
                    f"of the tolerance (the plain version {ratio_p:.3f}); "
                    f"vs plain max_abs_err {err:.3e}, {differ:.2%} of "
                    f"outputs differ; two launches "
                    f"{'the same bits' if torch.equal(y, again) else 'DIFFER'}")
                check(ok and ok_p and torch.equal(y, again)
                      and bool(torch.isfinite(y).all()), what)
                calls = lambda fn: rotate([functools.partial(fn, x, wi, b)
                                           for wi in ws])
                # Fewer timed launches where one takes tens of us or more.
                timed = functools.partial(time_ms, iters=20 if M <= 32 else 6,
                                          warmup=3 if M <= 32 else 1)
                ms = timed(calls(w8a16.mm_w8a16))
                plain_ms = timed(calls(w8a16.mm_w8a16_plain))
                if dtype == torch.bfloat16:
                    lib = lambda x, wi, b: torch.mm(
                        x, wi["q"].to(dtype), out_dtype=torch.float32)
                else:
                    lib = lambda x, wi, b: x @ wi["q"].to(dtype)
                library_ms = timed(calls(lib))
                pack_ms = None
                if pack is not None and dtype == torch.bfloat16 and M <= 32:
                    wt = w["q"].t().contiguous()
                    sb = w["s"].to(dtype)
                    try:
                        pack(x, wt, sb)
                        torch.cuda.synchronize()
                        pack_ms = time_ms(lambda: pack(x, wt, sb))
                    except (RuntimeError, NotImplementedError) as exc:
                        log(f"    torch._weight_int8pack_mm: "
                            f"{str(exc).splitlines()[0][:100]}")
                        pack = None
                e = x.element_size()
                bound, by = bound_ms(
                    I * O + e * M * I + e * M * O + 4 * O
                    + (0 if b is None else e * O), 2 * M * I * O,
                    "bf16" if dtype == torch.bfloat16 else "fp32")
                log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cast "
                    f"+ mm {library_ms:.4f} ms"
                    + (f", _weight_int8pack_mm {pack_ms:.4f} ms"
                       if pack_ms is not None else "")
                    + f"; bound {bound * 1e3:.3f} us ({by})")
                row["shapes"].append(dict(
                    M=M, I=I, O=O, dtype=str(dtype)[6:], bias=b is not None,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, int8pack_ms=pack_ms,
                    bound_ms=bound, bound_by=by))
                if (M, I, O, dtype) == (1, 1280, 1280, torch.bfloat16):
                    row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound, bound_by=by,
                               library_ms=library_ms)
        del ws
    return row


def check_w8a16_launches(launches, params, n_layer, flat_calls, prefills,
                         cross_kvs):
    """Every product with an int8 decoder weight launched the W8A16 kernel
    once, and a dense stack launched none: 8 a decoder layer (q, k, v, o,
    xq, xo, fc1, fc2) for each flat decoder call and each long prefill, 2
    a layer (xk, xv) for each cross-KV computation."""
    got = launches["mm_w8a16"]
    int8 = isinstance(params["decoder"]["layers"]["q_w"], dict)
    want = (n_layer * (8 * (flat_calls + prefills) + 2 * cross_kvs)
            if int8 else 0)
    log(f"  W8A16 launches {got} (expected "
        + (f"{n_layer} x (8 x ({flat_calls} flat decoder calls + "
           f"{prefills} long prefills) + 2 x {cross_kvs} cross-KV "
           f"computations) = {want})" if int8 else "0: dense weights)"))
    check(got == want, "the W8A16 kernel ran once for every int8-weight "
          "product")


@contextlib.contextmanager
def counting_prefills(whisper, cfg):
    """Counts model.decode's long prefills (S * heads > 128: the path that
    writes the block and attends in plain PyTorch) while it is open."""
    count = {"long": 0}
    decode = whisper.decode

    def counted(c, params, tokens, *args, **kw):
        if c == cfg and tokens.shape[1] * c.n_text_head > 128:
            count["long"] += 1
        return decode(c, params, tokens, *args, **kw)

    whisper.decode = counted
    try:
        yield count
    finally:
        whisper.decode = decode


BEAM = 5                     # the beam width of the beam phases (K)
BEAM_GROUPS = 4              # phase 4e's beam server: groups, and requests
BEAM_SECS = (5.0, 15.0, 30.0, 45.0)
PROMPT_LEN = 4               # sot, language, task, no/timestamps


def beam_masks(G: int, K: int, T: int, pos, gen) -> torch.Tensor:
    """Ancestry masks [G, K, K*T] as the grouped beam step takes them
    (test_fuzz.py's recipe): each group's beams inherit a random parent's
    ancestry at every step from PROMPT_LEN to pos[g], then each beam's own
    bit at pos[g] is set."""
    eye = torch.eye(K, dtype=torch.bool)
    t = torch.arange(T)
    masks = []
    for p_g in pos.tolist():
        anc = eye[:, :, None] & (t < PROMPT_LEN)
        for p in range(PROMPT_LEN, p_g + 1):
            anc = anc[torch.randint(0, K, (K,), generator=gen)]
            anc = anc | (eye[:, :, None] & (t == p))
        masks.append(anc.reshape(K, K * T))
    return torch.stack(masks).cuda()


# K4's beam mode in its earlier mask design (a K*T-byte mask a query, all
# K*T keys read): its times in this phase as PERF.md §6 records them (an
# NVIDIA H100 80GB HBM3 at 700.00 W), named as recorded in the log beside
# this run's (not in the kernels line, which holds only what this run
# measured).
BEAM_MASK_DESIGN_MS = {"": 0.0539, "oneshot_": 0.0575, "int8_": 0.0352,
               "oneshot_int8_": 0.0464}


def beam_holes(mask, pos, gen) -> torch.Tensor:
    """A copy of ancestry masks [G, K, K*T] with a quarter of the (beam,
    position) entries below each group's pos cleared at random and each
    beam's own bit at pos kept: source-row tables with -1 entries under
    the length, which random-parent ancestries never give."""
    G, K, KT = mask.shape
    T = KT // K
    drop = ((torch.rand(G, K, T, generator=gen) < 0.25)
            & (torch.arange(T) < pos[:, None, None])).to(mask.device)
    return (mask.view(G, K, K, T) & ~drop[:, :, None, :]).view(G, K, KT)


def check_beam_holes(da, quantize, G: int, T: int, K: int, H: int) -> None:
    """K4's beam mode on tables with -1 entries below the length (beam_holes
    of random-parent ancestries at pos = T - 2), bf16, int8 and fp32 (at
    T=448 the fp32 rows of n = 447 positions stream through the ring: 112
    passes against its 96). Every cache slot that no beam reads (its K, V
    and, int8, ks and vs) is NaN, and a launch on an all-NaN cache under a
    full table goes first, so that the slots of shared memory a skipped
    position leaves stale hold NaN too: a slot or scale read or summed
    where the table says -1 shows as a NaN. Held against the plain version
    on the clean cache with phase 2's tolerances (bf16 1e-2; int8 1e-2 and
    prob levels within one on <= 1e-3 of the visible keys; fp32 1e-5), and
    no prob on a hidden (beam, position)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 92)
    gen = torch.Generator().manual_seed(SEED + 93)
    HD = H * 64
    pos = torch.full((G,), T - 2)
    rows = da.ancestry_rows(beam_holes(beam_masks(G, K, T, pos, gen), pos,
                                       gen))
    lengths = (pos + 1).to(device=dev, dtype=torch.int32)
    t = torch.arange(T, device=dev)
    seen = (rows >= 0) & (t < lengths[:, None, None])            # [G, K, T]
    holes = int(((rows < 0) & (t < lengths[:, None, None])).sum())
    check(holes > 0, f"beam_holes (G={G}, T={T}): -1 entries below the "
                     f"length")
    own = torch.arange(K, device=dev)
    unread = ~((rows.long()[:, :, None, :] == own[:, None]) & seen[:, :, None]
               ).any(1).view(G, K * T, 1)            # no beam reads the slot
    hidden = ~seen[:, :, None, :].expand(G, K, H, T)
    full = own.to(torch.int8).view(1, K, 1).expand(G, K, T).contiguous()
    full_len = torch.full((G,), T, dtype=torch.int32, device=dev)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    q = rnd(G, K, HD).to(torch.bfloat16)
    kf, vf = (rnd(G, K * T, HD).to(torch.bfloat16) for _ in range(2))
    k8, v8 = (torch.empty(G, K * T, HD, dtype=torch.int8, device=dev)
              for _ in range(2))
    ks, vs = (torch.empty(G, K * T, H, device=dev) for _ in range(2))
    quantize.quantize_heads_kv(kf, vf, H, (k8, ks, v8, vs))
    n_vis = H * int(seen.sum())
    nan = float("nan")
    for mode, qm, k, v, kw in (
            ("bf16", q, kf, vf, {}),
            ("int8", q, k8, v8, dict(ks=ks, vs=vs)),
            ("fp32", q.float(), kf.float(), vf.float(), {})):
        poison = lambda x, where: (x.masked_fill(where, nan)
                                   if x.is_floating_point() else x)
        every = torch.ones_like(unread)
        da.attend_decode_beam(qm, *(poison(x, every) for x in (k, v)), full,
                              full_len, H, **{n: poison(x, every)
                                              for n, x in kw.items()})
        o, p = da.attend_decode_beam(
            qm, *(poison(x, unread) for x in (k, v)), rows, lengths, H,
            **{n: poison(x, unread) for n, x in kw.items()},
            return_probs=True)
        plain, p_plain = da.attend_decode_beam_plain(
            qm, k, v, rows, lengths, H, **kw, return_probs=True)
        torch.cuda.synchronize()
        e = (o.float() - plain.float()).abs().max().item()
        dp = (p - p_plain).abs()
        if mode == "int8":
            share = dp.ne(0).sum().item() / n_vis
            ok = e <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3
            detail = (f"prob levels max diff {dp.max().item():.0f} on "
                      f"{share:.2e} of visible keys")
        else:
            ok = e <= (1e-2 if mode == "bf16" else 1e-5)
            detail = f"probs max_abs_err {dp.max().item():.3e}"
        what = f"{mode}, G={G}, T={T}, K={K}, lengths {lengths.tolist()}"
        log(f"K4 attend_decode_beam with {holes} -1 entries below the length "
            f"({what}), unread slots NaN: max_abs_err {e:.3e}; {detail}")
        check(ok, f"K4 beam mode with -1 entries below the length ({what}) "
                  f"vs plain")
        check(bool((p[hidden] == 0).all()),
              f"K4 beam mode with -1 entries below the length ({what}): no "
              f"prob on a hidden (beam, position)")


def beam_bound(mask, HD: int, H: int, nb: int, all_keys: bool):
    """The least time for one beam-mode launch (K4): the keys it must read
    (the union of a group's visible keys) with their K and V rows (nb
    bytes a value; int8 adds 2 x H fp32 scales), the source-row table (a
    byte a (beam, position)) and the int32 lengths, the bf16 query and
    output; 4 x HD operations for each (query, visible key) pair. mask:
    the ancestry [G, K, K*T] the table came from. all_keys: the bound of
    the earlier mask design, every one of a group's K*T keys for every
    query under a byte of mask a key."""
    G, K, KT = mask.shape
    io = 2 * G * K * HD * 2
    scales = 2 * H * 4 if nb == 1 else 0
    if all_keys:
        return bound_ms(G * KT * (2 * HD * nb + scales) + mask.numel() + io,
                        4 * G * K * KT * HD, "fp32")
    keys = int(mask.any(dim=1).sum())
    return bound_ms(keys * (2 * HD * nb + scales) + G * KT + 4 * G + io,
                    4 * int(mask.sum()) * HD, "fp32")


def phase_beam_attention(da, quantize):
    """K4's beam mode (the grouped beam step's self-attention) at large-v3's
    width (20 heads, Dh 64, K = 5 beams): G=4 groups over T=128-row caches
    (the beam server's step) and G=1 over T=448 (the one-shot layout at
    full context), each on a bf16 cache and on an int8 self-cache whose
    levels and scales K3 wrote (and, checked only, G=1/T=448 on an fp32
    cache), under random-parent ancestry masks turned into the source-row
    table by ancestry_rows (lengths pos + 1): against the plain version
    (bf16 outputs 1e-2, as K4's self mode; int8 prob levels within one on
    <= 1e-3 of the visible keys), against itself over two launches, and
    with no prob on a hidden (beam, position). Then each is timed over 32
    per-layer copies (cold in L2) beside its plain version, SDPA with the
    boolean mask (bf16), the mask design's recorded time
    (BEAM_MASK_DESIGN_MS, in the log only) and two bounds: the visible
    keys' bytes with the table's, and the mask design's (all K*T keys with
    the mask's bytes). Last, at each shape, check_beam_holes: tables with
    -1 entries below the length, in bf16, int8 and fp32."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    gen = torch.Generator().manual_seed(SEED + 91)
    H, D, K = 20, 64, BEAM
    HD = H * D
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(name="decode_attention_direct_beam",
               source="openhush_tpu_torch/csrc/decode_attention.cu",
               replaces="openhush_tpu/ops/decode_attention.py:133",
               counter=da.attend_decode_beam, library_ms=None)
    for G, T, key in ((4, 128, ""), (1, 448, "oneshot_")):
        pos = torch.randint(PROMPT_LEN, T, (G,), generator=gen)
        mask = beam_masks(G, K, T, pos, gen)
        rows = da.ancestry_rows(mask)
        lengths = (pos + 1).to(device=dev, dtype=torch.int32)
        hidden = (rows < 0)[:, :, None, :].expand(G, K, H, T)
        q = rnd(G, K, HD).to(torch.bfloat16)
        kf, vf = (rnd(G, K * T, HD).to(torch.bfloat16) for _ in range(2))
        k8, v8 = (torch.empty(G, K * T, HD, dtype=torch.int8, device=dev)
                  for _ in range(2))
        ks, vs = (torch.empty(G, K * T, H, device=dev) for _ in range(2))
        quantize.quantize_heads_kv(kf, vf, H, (k8, ks, v8, vs))
        n_vis = H * int(mask.sum())
        for mode, (k, v, kw) in (("bf16", (kf, vf, {})),
                                 ("int8", (k8, v8, dict(ks=ks, vs=vs)))):
            args = (q, k, v, rows, lengths, H)
            (o, p), (o2, p2) = (da.attend_decode_beam(
                *args, **kw, return_probs=True) for _ in range(2))
            plain, p_plain = da.attend_decode_beam_plain(
                *args, **kw, return_probs=True)
            torch.cuda.synchronize()
            what = f"{mode}, G={G}, T={T}, K={K}"
            check(torch.equal(o, o2) and torch.equal(p, p2),
                  f"K4 beam mode ({what}): the same bits over two launches")
            e = (o.float() - plain.float()).abs().max().item()
            dp = (p - p_plain).abs()
            if mode == "bf16":
                tol_ok = e <= 1e-2
                detail = f"bf16 probs max_abs_err {dp.max().item():.3e}"
            else:
                share = dp.ne(0).sum().item() / n_vis
                tol_ok = e <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3
                detail = (f"int8 prob levels max diff {dp.max().item():.0f} "
                          f"on {share:.2e} of visible keys (tolerance 1 "
                          f"level on <= 1e-3)")
            check(bool((p[hidden] == 0).all()),
                  f"K4 beam mode ({what}): no prob on a hidden (beam, "
                  f"position)")
            log(f"K4 attend_decode_beam ({what}, source-row tables from "
                f"random-parent ancestries, {int(mask.sum())} visible "
                f"(query, key) pairs of {mask.numel()}, lengths "
                f"{lengths.tolist()}): max_abs_err {e:.3e} (tolerance 1e-2: "
                f"bf16 outputs); {detail}; the same bits over two launches")
            check(tol_ok, f"K4 beam mode vs plain ({what})")
            layers = [(k.clone(), v.clone(), {n: t.clone()
                                              for n, t in kw.items()})
                      for _ in range(N_LAYER)]
            on_layers = lambda fn: rotate([
                functools.partial(fn, q, kl, vl, rows, lengths, H, **kwl)
                for kl, vl, kwl in layers])
            ms = time_ms(on_layers(da.attend_decode_beam), iters=2 * N_LAYER)
            plain_ms = time_ms(on_layers(da.attend_decode_beam_plain))
            nb = 2 if mode == "bf16" else 1
            b, by = beam_bound(mask, HD, H, nb, False)
            b_all = beam_bound(mask, HD, H, nb, True)[0]
            pre = key + ("" if mode == "bf16" else "int8_")
            line = (f"  K4 beam mode {what}: kernel {ms:.4f} ms (the mask "
                    f"design, recorded: {BEAM_MASK_DESIGN_MS[pre]:.4f} "
                    f"ms), plain "
                    f"{plain_ms:.4f} ms, bound {b * 1e3:.3f} us ({by}, the "
                    f"visible keys and the table), {b_all * 1e3:.3f} us "
                    f"(the mask design: all K*T keys and the mask)")
            if mode == "bf16":
                heads = lambda x: x.view(G, -1, H, D).transpose(1, 2)
                lib = sdpa(heads(q), heads(kf), heads(vf),
                           attn_mask=mask[:, None])
                lib_err = (lib.transpose(1, 2).reshape(G, K, HD).float()
                           - plain.float()).abs().max().item()
                lib_ms = time_ms(rotate([
                    functools.partial(sdpa, heads(q), heads(kl), heads(vl),
                                      attn_mask=mask[:, None])
                    for kl, vl, _ in layers]), iters=2 * N_LAYER)
                line += (f", SDPA (boolean mask [G, 1, K, K*T]) {lib_ms:.4f} "
                         f"ms (max_abs_err vs plain {lib_err:.3e})")
            log(line)
            del layers
            if pre == "":
                row.update(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, library_ms=lib_ms,
                           all_keys_bound_ms=b_all)
            else:
                row.update({pre + "ms": ms, pre + "plain_ms": plain_ms,
                            pre + "bound_ms": b,
                            pre + "all_keys_bound_ms": b_all})
                if mode == "bf16":
                    row[pre + "library_ms"] = lib_ms
        if T == 448:      # fp32 (an fp32 engine's beam): rows of 256 B, in
            qf, kf32, vf32 = (x.float() for x in (q, kf, vf))   # flight whole
            o, o2 = (da.attend_decode_beam(qf, kf32, vf32, rows, lengths, H)
                     for _ in range(2))   # at this n (the ring: check_beam_holes)
            plain = da.attend_decode_beam_plain(qf, kf32, vf32, rows,
                                                lengths, H)
            e = (o - plain).abs().max().item()
            log(f"K4 attend_decode_beam (fp32, G={G}, T={T}, K={K}, lengths "
                f"{lengths.tolist()}): max_abs_err {e:.3e} (tolerance 1e-5: "
                f"fp32 sums reordered, as K4's self mode on 448 rows); the "
                f"same bits over two launches")
            check(torch.equal(o, o2) and e <= 1e-5,
                  f"K4 beam mode (fp32, G={G}, T={T}) vs plain, and over two "
                  f"launches")
        check_beam_holes(da, quantize, G, T, K, H)
    return [row]


def phase_flash_backward(fa, k2_row):
    """K2's residual mode (the per-row log-sum-exp), K6 (dK, dV) and K7 (dQ)
    at the large-v3 encoder's shapes (20 heads, T=1500, Dh=64, read through
    the strided [B, T, H*Dh] projection layout as encode() does): against
    their plain versions on the same inputs, in fp32 at the fine-tune
    phase's shape (B=2) and at T=333, and in bf16 at B=1; in fp32 each
    held to the same bits over two launches; then timed on the fp32 B=2
    inputs that were checked, beside their bounds (on the tensor cores at
    fp32 accuracy, and the fp32 CUDA cores'), the backward of SDPA on the
    same inputs, and the split pass that K6 and K7 share. K2's fp32
    residual-mode time, its plain version's, its bounds and SDPA's fp32
    forward on the same inputs go into K2's row (`k2_row`)."""
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
    # K2's fp32 path, K6 and K7 at a T that is not a multiple of their
    # 64- or 128-row tiles.
    x = [torch.randn(1, 333, H * D, generator=g, device=dev).view(
        1, 333, H, D).transpose(1, 2) for _ in range(4)]
    o, lse = fa.attend_lse(*x[:3])
    ours = fa.flash_attention_lse(*x[:3])
    errs = [(a - b).abs().max().item() for a, b in zip(ours, (o, lse))]
    rest = (x[3], lse, fa.delta_rows(o, x[3]))
    rel = [(a - b).abs().max().item() / b.abs().max().item() for a, b in
           zip((*fa.flash_attention_bwd_dkv(*x[:3], *rest),
                fa.flash_attention_bwd_dq(*x[:3], *rest)),
               (*fa.backward_dkv_plain(*x[:3], *rest),
                fa.backward_dq_plain(*x[:3], *rest)))]
    log(f"K2 residual mode (fp32, B=1, T=333): output max_abs_err "
        f"{errs[0]:.3e}, lse {errs[1]:.3e} (tolerance 1e-4); K6/K7: "
        f"max_abs_err / max|plain| dk {rel[0]:.3e}, dv {rel[1]:.3e}, dq "
        f"{rel[2]:.3e} (tolerance 1e-4)")
    check(max(errs) <= 1e-4, "K2 fp32 T=333 vs plain")
    check(max(rel) <= 1e-4, "K6/K7 fp32 T=333 vs plain")
    # The fine-tune's shape, fp32: these inputs are checked, then timed, and
    # their errors are the kernels line's max_abs_err.
    B = 2
    args, abs_errs = compare(B, torch.float32)
    for name, fn, a in (("K2 residual mode", fa.flash_attention_lse, args[:3]),
                        ("K6", fa.flash_attention_bwd_dkv, args),
                        ("K7", fa.flash_attention_bwd_dq, args)):
        first, again = fn(*a), fn(*a)
        if torch.is_tensor(first):
            first, again = (first,), (again,)
        check(all(torch.equal(x, y) for x, y in zip(first, again)),
              f"{name}: the same bits over two launches")
        log(f"  {name} (fp32, B=2): the same bits over two launches")
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
    k2_plain_ms = time_ms(lambda: fa.attend_lse(q, k, v))
    k2_sdpa_ms = time_ms(lambda: sdpa(q, k, v))
    # Four fp32 [B, H, T, Dh] tensors and the lse moved; 2 T x T x Dh
    # products, each six bf16 products on the tensor cores at fp32 accuracy.
    k2_bytes, k2_flops = 4 * elems + B * H * T * 4, 4 * B * H * T * T * D
    k2_bound, k2_by = bound_ms(k2_bytes, 6 * k2_flops, "bf16")
    k2_cc_bound = bound_ms(k2_bytes, k2_flops, "fp32")[0]
    log(f"  K2 residual mode (fp32, B=2): {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}, six bf16 "
        f"partial products a product), fp32 CUDA-core bound "
        f"{k2_cc_bound:.4f} ms, SDPA fp32 forward {k2_sdpa_ms:.4f} ms; "
        f"inference mode {time_ms(lambda: fa.flash_attention(q, k, v)):.4f}"
        f" ms")
    k2_row.update(fp32_residual_ms=k2_ms, fp32_residual_bound_ms=k2_bound,
                  fp32_residual_cuda_core_bound_ms=k2_cc_bound,
                  fp32_residual_plain_ms=k2_plain_ms,
                  fp32_residual_library_ms=k2_sdpa_ms)
    # The split pass: alone, and what sharing it saves a backward (one
    # split for K6 and K7 against one each).
    planes = fa.split_planes(q, k, v, do)
    check(torch.equal(planes, fa.split_planes_plain(q, k, v, do)),
          "split pass vs plain")
    log("  split pass of q, k, v, dO (fp32, B=2): the plain version's bits")
    split_ms = time_ms(lambda: fa.split_planes(q, k, v, do))
    shared_ms = {fn: time_ms(lambda: fn(*args, planes)) for fn in
                 (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)}
    rows = []
    for name, fn, plain, wrt, n_out, n_mm, err, src in (
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
             fa.backward_dkv_plain, leaves[1:], 2, 4, err_dkv,
             "flash_attention_bwd_tc.cu"),
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
             fa.backward_dq_plain, leaves[:1], 1, 3, err_dq,
             "flash_attention_bwd_tc.cu")):
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
            bound_ms=b, bound_by=by, library_ms=lib(wrt),
            split_ms=split_ms, on_shared_planes_ms=shared_ms[fn]))
        # On the tensor cores each fp32 product is six bf16 products (three
        # bf16 parts an operand): the least time for the same function at
        # fp32 accuracy. The CUDA-core bound stays beside it.
        rows[-1]["cuda_core_bound_ms"] = b
        rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound_ms(
            n_bytes, 6 * flops, "bf16")
    for r in rows:
        log(f"  {r['name']} (fp32, B=2): kernel {r['ms']:.4f} ms (on a "
            f"split it shares {r['on_shared_planes_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, six bf16 partial products a product), fp32 "
            f"CUDA-core bound {r['cuda_core_bound_ms']:.4f} ms, SDPA "
            f"backward for the same gradients {r['library_ms']:.4f} ms")
    log(f"  split pass of q, k, v, dO (fp32, B=2): {split_ms:.4f} ms; one "
        f"backward with a split each "
        f"{rows[0]['ms'] + rows[1]['ms']:.4f} ms, with one split shared "
        f"{split_ms + sum(shared_ms.values()):.4f} ms")
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
                fa.flash_attention_bwd_dq, fa.split_planes)
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
    check(all(fn.launches == n for fn in counters[:3])
          and fa.split_planes.launches == 2 * n,
          "the card ran K2 residual mode, K6 and K7 once and the split pass "
          "twice (forward, backward) per encoder layer and step")


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
                fa.flash_attention_bwd_dq, fa.split_planes)
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
    check(all(launches[fn.__name__] == n for fn in counters[:3])
          and launches["split_planes"] == 2 * n,
          f"K2 residual mode, K6 and K7 ran {n} times (32 x steps), the "
          f"split pass {2 * n} (forward and backward)")

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
        split = sum(us for name, us in by_name.items()
                    if "split_planes" in name)
        log(f"  traced step: {traced * 1e3:.1f} ms wall, device busy "
            f"{busy / 1e3:.1f} ms, device idle share "
            f"{1 - busy / 1e6 / traced:.3f}; flash kernels (K2, K6, K7) "
            f"{flash / 1e3:.1f} ms = {flash / busy:.1%}, their split pass "
            f"{split / 1e3:.1f} ms = {split / busy:.1%}")
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


def emitted(res, max_new: int, eot: int) -> int:
    """Tokens a DecodingResult's rows emitted: each row's content tokens,
    and its EOT when it ended before max_new."""
    content = (res.tokens[:, res.prompt_len:] != eot).sum(axis=1)
    return int(np.minimum(content + 1, max_new).sum())


def serve_windows(srv, audios, turns=400):
    """Every window of `audios` through `srv` (run_once until done) →
    [content tokens] in order."""
    sids = [srv.open_session() for _ in audios]
    for sid, a in zip(sids, audios):
        srv.submit_window(sid, a, language="en")
    got = {}
    for _ in range(turns):
        srv.run_once()
        for sid in sids:
            r = srv.poll(sid)
            if r is not None:
                got[sid] = r.tokens
        if len(got) == len(sids):
            break
    check(len(got) == len(sids), "server finished every window")
    return [got[sid] for sid in sids]


def phase_spec_tiny(speculative, decoding, whisper, weights, get_config,
                    frontend, mel, EngineServer, max_new=32):
    """tiny, fp32, speculative decoding on the card, with a random 1-layer
    draft of tiny's width and with tiny as its own draft (whose proposals
    match, so blocks are accepted several tokens deep): the one-shot
    speculative loop (K=5, 2 windows) on the card gives the CPU's tokens
    from the same weights and fp32 cross-KVs (the CPU's), and the card's
    greedy loop's; then a spec server (spec_policy "always", k_spec 4; 3
    windows over 2 slots) on the card gives a plain server's tokens."""
    import dataclasses
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tiny")
    dcfg = dataclasses.replace(cfg, name="tiny-draft", n_text_layer=1)
    cpu = weights.init_params(cfg, torch.Generator().manual_seed(SEED + 80),
                              torch.float32, "cpu")
    dcpu = weights.init_params(dcfg, torch.Generator().manual_seed(SEED + 81),
                               torch.float32, "cpu")
    gpu, dgpu = to_device(cpu, "cuda"), to_device(dcpu, "cuda")
    from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
    tok = WhisperTokenizer(cfg.n_langs)
    cuda = lambda kv: whisper.KVCache(kv.k.cuda(), kv.v.cuda())
    opts = decoding.DecodingOptions(language="en", max_new_tokens=max_new)
    loop = speculative.speculative_greedy_loop
    with torch.inference_mode():
        windows = torch.stack([torch.from_numpy(mel.pad_or_trim(
            speechlike(secs, SEED + 82 + i))) for i, secs in
            enumerate((8.0, 12.0))])
        feats = whisper.encode(cfg, cpu, frontend.log_mel(windows,
                                                          cfg.n_mels))
        xkv = whisper.compute_cross_kv(cfg, cpu, feats)
        dxkv = whisper.compute_cross_kv(dcfg, dcpu, feats)
        greedy = decoding.decode_greedy(cfg, gpu, cuda(xkv), tok, opts)
        for name, dc, dparams, dkv in (("random draft", dcfg, (dcpu, dgpu),
                                        dxkv),
                                       ("self-draft", cfg, (cpu, gpu), xkv)):
            res, verifies = {}, {}
            for i, (dev, params, kv, dk) in enumerate((
                    ("cpu", cpu, xkv, dkv), ("cuda", gpu, cuda(xkv),
                                             cuda(dkv)))):
                before = loop.verifies
                res[dev] = speculative.decode_speculative(
                    cfg, params, dc, dparams[i], kv, dk, tok, opts,
                    k_spec=K_ONESHOT)
                verifies[dev] = loop.verifies - before
            same = np.array_equal(res["cpu"].tokens, res["cuda"].tokens)
            as_greedy = np.array_equal(res["cuda"].tokens, greedy.tokens)
            n = emitted(res["cuda"], max_new, tok.special.eot)
            log(f"  tiny fp32 one-shot speculative ({name}, K={K_ONESHOT}, "
                f"2 windows, {max_new} tokens): card vs CPU tokens "
                f"{'equal' if same else 'DIFFERENT'}, card vs the card's "
                f"greedy {'equal' if as_greedy else 'DIFFERENT'}; {n} "
                f"tokens emitted over {verifies['cuda']} verify passes of "
                f"2 rows")
            check(same and as_greedy and verifies["cpu"] == verifies["cuda"],
                  f"tiny speculative ({name}): card tokens == CPU tokens == "
                  f"greedy tokens")

    plen = len(tok.sot_sequence("en", "transcribe"))
    kw = dict(n_slots=2, inner_steps=8, dtype=torch.float32, tokenizer=tok,
              max_decode_len=plen + max_new + 1, temperatures=(0.0,),
              logprob_threshold=-1e9, no_speech_threshold=2.0,
              max_admissions_per_turn=2)
    audios = [speechlike(secs, SEED + 84 + i)
              for i, secs in enumerate((8.0, 12.0, 20.0))]
    plain = serve_windows(EngineServer(cfg, gpu, **kw), audios)
    for name, draft in (("random draft", (dcfg, dgpu)),
                        ("self-draft", (cfg, gpu))):
        srv = EngineServer(cfg, gpu, draft=draft, spec_policy="always",
                           k_spec=K_SPEC, **kw)
        got = serve_windows(srv, audios)
        n_tok = sum(len(t) for t in got)
        log(f"  tiny fp32 spec server ({name}, k_spec {K_SPEC}) vs plain "
            f"server on the card: {n_tok} tokens in {srv.spec_iters} "
            f"iterations, {'equal' if got == plain else 'DIFFERENT'}")
        check(srv.spec_iters > 0 and got == plain,
              f"tiny spec server ({name}) tokens == plain server tokens")


def phase_int8_tiny(WhisperEngine, EngineServer, batcher, whisper, weights,
                    get_config, frontend, mel, max_new=32):
    """tiny, fp32, with all three int8 rungs on (int8 decoder weights, the
    W8A8 encoder, the int8 self-cache): the card against the CPU from the
    same fp32 weights, each side's engine quantizing them.
    - The quantized weights: the same bits.
    - The W8A8 arithmetic on the same inputs (the per-row quantize and the
      int8 product with both folds, at an encoder layer's shape): the same
      bits.
    - The W8A8 features from the same log-mel, held to the dense fp32
      features of the same weights: the card's as close to them as the
      CPU's (median distance within 10% of the CPU's, max within 25%: an
      extreme of another draw of the same noise), and the two
      W8A8 encoders closer to each other than to the dense one (median).
      They are not equal to fp32 noise: the card's flash kernel differs
      from the plain attention by ~1e-5, the per-row quantize turns that
      into level flips at .5 ties, and each flip moves its row by one
      level of the row's scale.
    - On the CPU's int8 cross-KV, the decoder over an int8 self-cache (the
      prompt, then 8 steps teacher-forced with the CPU's greedy tokens):
      logits atol 2e-3 (as phase 3's fp32 prompt logits), written levels
      within one on <= 1e-3, scales rtol 1e-3 (an int8 prob level of K4
      or K5 moved at a .5 tie moves the next layer's keys by ~1e-4).
    - An int8-self-cache EngineServer on each (three windows over two
      slots, t=0, guards off; the card's server decodes the CPU server's
      prepared cross-KV): the same tokens, up to the first step where the
      CPU's top two filtered logits lie within four times the logits error
      measured above (floor 1e-4), where a tie may go either way: random
      tiny weights give logits of ~0.4 whose top two are often under 1e-3
      apart."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tiny")
    base = weights.init_params(cfg, torch.Generator().manual_seed(SEED + 80),
                               torch.float32, "cpu")
    rungs = dict(quantize_weights=True, quantize_encoder=True)
    engs = {dev: WhisperEngine("tiny", params=to_device(base, dev),
                               device=dev, **rungs) for dev in ("cpu", "cuda")}
    cpu, gpu = engs["cpu"].params, engs["cuda"].params
    for part in ("encoder", "decoder"):
        for name, w in cpu[part]["layers"].items():
            if name.endswith("_w"):
                check(isinstance(w, dict) and all(torch.equal(
                    w[k], gpu[part]["layers"][name][k].cpu()) for k in w),
                    f"tiny {part} {name}: the card's int8 weights are the "
                    f"CPU's bits")
    log("  tiny int8 rungs: the card's quantized weights are the CPU's bits")
    tok = engs["cpu"].tokenizer
    feats = {}
    with torch.inference_mode():
        g = torch.Generator().manual_seed(SEED + 83)
        h = 3 * torch.randn(1, cfg.n_audio_ctx, cfg.n_audio_state, generator=g)
        pieces = {}
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            lp = whisper._layers(params["encoder"]["layers"])[0]
            h8, hs = whisper._quantize_rows(h.to(dev))
            pieces[dev] = [t.cpu() for t in (
                h8, hs, whisper._mm_i8(h8, hs, lp["fc1_w"]))]
        same = all(torch.equal(a, b) for a, b in zip(*pieces.values()))
        log(f"  tiny W8A8 per-row quantize and int8 product with its folds "
            f"([1, {cfg.n_audio_ctx}, {cfg.n_audio_state}] x fc1): card vs "
            f"CPU {'the same bits' if same else 'DIFFERENT'}")
        check(same, "tiny W8A8 pieces card vs CPU")
        window = torch.from_numpy(mel.pad_or_trim(speechlike(10.0, SEED + 81)))
        m = frontend.log_mel(window[None], cfg.n_mels)      # the CPU's
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            feats[dev] = whisper.encode(cfg, params, m.to(dev)).cpu()
        dense = whisper.encode(cfg, base, m)
        dist = lambda a, b: ((a - b).abs().median().item(),
                             (a - b).abs().max().item())
        (med, top), (c_med, c_top), (g_med, g_top) = (
            dist(feats["cuda"], feats["cpu"]), dist(feats["cpu"], dense),
            dist(feats["cuda"], dense))
        log(f"  tiny W8A8 encoder features from the same log-mel: from the "
            f"dense fp32 features, card median {g_med:.3e} max {g_top:.3e}, "
            f"CPU median {c_med:.3e} max {c_top:.3e} (tolerance: the card's "
            f"within 10% and 25% of the CPU's); card vs CPU median {med:.3e} "
            f"(tolerance: under the CPU's from dense), max {top:.3e}")
        check(bool(torch.isfinite(feats["cuda"]).all())
              and g_med <= 1.1 * c_med and g_top <= 1.25 * c_top
              and med <= c_med, "tiny W8A8 features card vs CPU")
        xkv = whisper.compute_cross_kv_quant(cfg, cpu, feats["cpu"])
        prompt = torch.tensor([tok.sot_sequence("en")])
        logits, caches, toks = {}, {}, []
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            kv = whisper.QuantKVCache(*(t.to(dev) for t in (
                xkv.k, xkv.k_scale, xkv.v, xkv.v_scale)))
            cache = whisper.init_quant_kv_cache(cfg, 1, 64, device=dev)
            lg, cache = whisper.decode(cfg, params, prompt.to(dev), 0, cache,
                                       kv)
            out, pos = [lg[0, -1].cpu()], prompt.shape[1]
            for s in range(8):
                if dev == "cpu":               # the CPU's greedy tokens
                    toks.append(out[-1][:cfg.n_vocab].argmax())
                lg, cache = whisper.decode(cfg, params,
                                           toks[s].reshape(1, 1).to(dev),
                                           pos, cache, kv)
                out.append(lg[0, -1].cpu())
                pos += 1
            logits[dev], caches[dev] = torch.stack(out), cache
    lc, lg = (logits[d][:, :cfg.n_vocab] for d in ("cpu", "cuda"))
    e = (lc - lg).abs().max().item()
    c, g = caches["cpu"], caches["cuda"]
    dq = max((a.cpu().int() - b.int()).abs().max().item()
             for a, b in ((g.k, c.k), (g.v, c.v)))
    share = max((a.cpu() != b).float().mean().item()
                for a, b in ((g.k, c.k), (g.v, c.v)))
    s_err = max(((a.cpu() - b).abs() / b.abs().clamp(min=1e-30)).max().item()
                for a, b in ((g.k_scale, c.k_scale), (g.v_scale, c.v_scale)))
    log(f"  tiny int8 decoder (int8 weights, int8 self-cache, prefill + 8 "
        f"steps): logits card vs CPU max_abs_err {e:.3e} (tolerance 2e-3; "
        f"logits up to {lc.abs().max().item():.3f}); written self-cache "
        f"levels max diff {dq} on {share:.2e} (tolerance 1 on <= 1e-3), "
        f"scales max rel err {s_err:.3e} (tolerance 1e-3)")
    check(e <= 2e-3 and dq <= 1 and share <= 1e-3 and s_err <= 1e-3,
          "tiny int8 decoder card vs CPU")

    audios = [speechlike(secs, SEED + 82 + i)
              for i, secs in enumerate((8.0, 12.0, 20.0))]
    plen = len(tok.sot_sequence("en", "transcribe"))
    kw = dict(n_slots=2, inner_steps=8, dtype=torch.float32, tokenizer=tok,
              max_decode_len=plen + max_new + 1, temperatures=(0.0,),
              logprob_threshold=-1e9, no_speech_threshold=2.0,
              max_admissions_per_turn=2, int8_self_cache=True)
    srv = {dev: EngineServer(cfg, engs[dev].params, **kw)
           for dev in ("cpu", "cuda")}
    check(all(s.state.cache_k.dtype == torch.int8 for s in srv.values()),
          "int8 self-cache servers")

    def cpu_prep(windows, detect):
        kv, probs, _ = srv["cpu"]._prep(windows.cpu(), detect)
        return (whisper.QuantKVCache(*(t.cuda() for t in (
            kv.k, kv.k_scale, kv.v, kv.v_scale))),
            None if probs is None else probs.cuda(), None)

    srv["cuda"]._prep = cpu_prep
    # The CPU's decision margins, by session: the top two filtered logits
    # of each live slot at each step.
    margins, choose = {}, batcher._choose_tokens

    def recording_choose(lg, st):
        top2 = lg.topk(2, dim=-1).values
        live = (st.active & ~st.finished).tolist()
        for b, info in srv["cpu"]._slots.items():
            if live[b]:
                margins.setdefault(info.session_id, []).append(
                    (top2[b, 0] - top2[b, 1]).item())
        return choose(lg, st)

    got = {}
    for dev, s in srv.items():
        sids = [s.open_session() for _ in audios]
        for sid, a in zip(sids, audios):
            s.submit_window(sid, a, language="en")
        out = {}
        if dev == "cpu":
            batcher._choose_tokens = recording_choose
        try:
            for _ in range(200):
                s.run_once()
                for sid in sids:
                    r = s.poll(sid)
                    if r is not None:
                        out[sid] = r.tokens
                if len(out) == len(sids):
                    break
        finally:
            batcher._choose_tokens = choose
        check(len(out) == len(sids), f"tiny int8 server ({dev}) finished")
        got[dev] = [(out[sid], margins.get(sid)) for sid in sids]
    tie = max(4 * e, 1e-4)
    for (ref, m), (ours, _) in zip(got["cpu"], got["cuda"]):
        k = next((i for i, (a, b) in enumerate(zip(ref, ours)) if a != b),
                 min(len(ref), len(ours)))
        same = ref == ours
        log(f"  tiny int8 server, card vs CPU: {len(ours)} tokens, "
            + ("equal" if same else
               f"equal up to token {k}, where the CPU's margin is "
               f"{m[min(k, len(m) - 1)]:.2e} (a tie within {tie:.1e})"))
        check(same or m[min(k, len(m) - 1)] <= tie,
              "tiny int8 server tokens card == CPU up "
              "to a tie")


def phase_beam_tiny(beam, decoding, whisper, weights, get_config, frontend,
                    mel, steps=6):
    """tiny, fp32, K=5 (K·H = 30: the grouped step): the one-shot beam on
    the card gives the CPU's tokens from the same weights and the same fp32
    cross-KV (the CPU's); then the grouped beam step on the card (K4's beam
    mode) against the gather oracle on the card (the cache rows gathered by
    parent, a per-row decode step on the K-tiled cross-KV: K4's direct
    path) over `steps` steps of random parents, 2 groups: logits atol 1e-4
    (fp32 sums in another order over 4 layers); last, decode(cross_group=K)
    on the card against the same step on the K-tiled cross-KV (atol
    1e-5)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tiny")
    K = BEAM
    cpu = weights.init_params(cfg, torch.Generator().manual_seed(SEED + 70),
                              torch.float32, "cpu")
    gpu = to_device(cpu, "cuda")
    from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
    tok = WhisperTokenizer(cfg.n_langs)
    with torch.inference_mode():
        windows = torch.stack([torch.from_numpy(mel.pad_or_trim(
            speechlike(secs, SEED + 71 + i))) for i, secs in
            enumerate((8.0, 12.0))])
        feats = whisper.encode(cfg, cpu, frontend.log_mel(windows,
                                                          cfg.n_mels))
        xkv = whisper.compute_cross_kv(cfg, cpu, feats)
        xkv_gpu = whisper.KVCache(xkv.k.cuda(), xkv.v.cuda())
        opts = decoding.DecodingOptions(language="en", beam_size=K,
                                        max_new_tokens=32)
        res = {dev: beam.decode_beam(cfg, params, kv, tok, opts)
               for dev, params, kv in (("cpu", cpu, xkv),
                                       ("cuda", gpu, xkv_gpu))}
    same = np.array_equal(res["cpu"].tokens, res["cuda"].tokens)
    d_score = np.abs(res["cpu"].avg_logprob - res["cuda"].avg_logprob).max()
    log(f"  tiny fp32 one-shot beam (K={K}, 2 windows, 32 tokens): card vs "
        f"CPU tokens {'equal' if same else 'DIFFERENT'}, scores max_abs_err "
        f"{d_score:.3e} (tolerance 1e-4: fp32 sums of 32 steps' logprobs)")
    check(same and d_score <= 1e-4, "tiny beam card tokens == CPU tokens")

    # The grouped step against the gather oracle, on the card.
    G, T = 2, 64
    prompt = torch.tensor([tok.sot_sequence("en", "transcribe",
                                            timestamps=False)] * G).cuda()
    P = prompt.shape[1]
    gen = torch.Generator().manual_seed(SEED + 72)
    with torch.inference_mode():
        cache = whisper.init_kv_cache(cfg, G, torch.float32, T, "cuda")
        _, cache = whisper.decode(cfg, gpu, prompt, 0, cache, xkv_gpu)
        cache = beam._tile(cache, K)
        tiled_prompt = whisper.KVCache(cache.k.clone(), cache.v.clone())
        oracle = whisper.KVCache(cache.k.clone(), cache.v.clone())
        tiled = beam._tile(xkv_gpu, K)
        anc = whisper.beam_ancestry(G, K, T, P, "cuda")
        err = 0.0
        for step in range(steps):
            pos = torch.full((G,), P + step, device="cuda")
            parents = torch.randint(0, K, (G, K), generator=gen).cuda()
            tokens = torch.randint(0, cfg.n_vocab, (G, K),
                                   generator=gen).cuda()
            anc = whisper.beam_own(beam._gather_beams(anc, parents), pos)
            lg, cache = whisper.decode_beam_step(
                cfg, gpu, tokens, pos, cache, anc.view(G, K, K * T), xkv_gpu)
            flat = (parents + torch.arange(G, device="cuda")[:, None] * K
                    ).view(-1)
            oracle = whisper.KVCache(oracle.k[:, flat], oracle.v[:, flat])
            lo, oracle = whisper.decode(cfg, gpu, tokens.view(G * K, 1),
                                        pos.repeat_interleave(K), oracle,
                                        tiled)
            err = max(err, (lg.view(G * K, -1)[:, :cfg.n_vocab]
                            - lo[:, -1, :cfg.n_vocab]).abs().max().item())
    log(f"  tiny fp32 grouped beam step vs gather oracle on the card ({steps} "
        f"steps of random parents, G={G}, K={K}): logits max_abs_err "
        f"{err:.3e} (tolerance 1e-4)")
    check(err <= 1e-4, "tiny grouped beam step vs gather oracle")
    with torch.inference_mode():
        toks = torch.randint(0, cfg.n_vocab, (G * K, 1), generator=gen).cuda()
        pos = torch.full((G * K,), P, device="cuda")
        step = lambda kv, group: whisper.decode(
            cfg, gpu, toks, pos, whisper.KVCache(tiled_prompt.k.clone(),
                                                 tiled_prompt.v.clone()),
            kv, cross_group=group)[0]
        err = (step(xkv_gpu, K) - step(tiled, 1)).abs().max().item()
    log(f"  tiny fp32 decode(cross_group={K}) vs the K-tiled cross-KV on the "
        f"card: logits max_abs_err {err:.3e} (tolerance 1e-5)")
    check(err <= 1e-5, "tiny decode(cross_group) vs tiled cross-KV")


def check_decode_launches(launches, flat_calls, n_layer, int8_self=None,
                          flat_layers=None, draft_layers=None):
    """Every flat decoder call launches K4 (self) and K5 (cross) once per
    decoder layer it runs: flat_layers in all (model._decode_flat_ro.layers
    of the run). Without a draft every call is the big model's, n_layer
    layers each; with a draft of draft_layers layers, the two counts split
    the calls into the big model's and the draft's. With an int8
    self-cache, int8_self = (the flat calls that wrote it, the cross-KV
    computations[, the draft's int8 cross-KV computations]) of the same
    run: K3 runs once per layer for each, the new keys' and the cross K
    and V's (a draft's cross-KV once per draft layer). Returns (the big
    model's flat calls, the draft's)."""
    if flat_layers is None:
        flat_layers = n_layer * flat_calls
    draft = 0
    if draft_layers is not None:
        draft, rem = divmod(n_layer * flat_calls - flat_layers,
                            n_layer - draft_layers)
        check(rem == 0 and 0 < draft < flat_calls,
              "the flat calls split into the big model's and the draft's")
    big = flat_calls - draft
    k4 = launches["attend_decode"]
    k5 = launches["attend_decode_pipelined"]
    log(f"  flat decoder calls {flat_calls} ({big} of the {n_layer}-layer "
        f"model, {draft} of the draft): K4 launches {k4}, K5 launches {k5} "
        f"(expected {n_layer} x {big} + {draft_layers or 0} x {draft} = "
        f"{n_layer * big + (draft_layers or 0) * draft})")
    check(flat_calls > 0 and flat_layers == n_layer * big
          + (draft_layers or 0) * draft and k4 == k5 == flat_layers,
          "K4 and K5 ran once per decoder layer and flat decoder call of "
          "each model")
    if int8_self is not None:
        writes, xkv_calls, *draft_xkv = int8_self
        draft_xkv = draft_xkv[0] if draft_xkv else 0
        k3 = launches["quantize_heads_kv"]
        want = n_layer * (writes + xkv_calls) + (draft_layers or 0) * draft_xkv
        log(f"  K3 launches {k3} (expected {n_layer} x ({writes} flat "
            f"decoder calls on the int8 self-cache + {xkv_calls} cross-KV "
            f"computations)"
            + (f" + {draft_layers} x {draft_xkv} of the draft's cross-KV"
               if draft_xkv else "") + f" = {want})")
        check(k3 == want, "K3 ran once per decoder layer and flat decoder "
              "call (the int8 self-cache's new keys), and once per layer "
              "and cross-KV computation")
    return big, draft


def phase_main_path(eng, whisper, counters, n_layer, secs=(20.0, 45.0)):
    """The one-shot path: `eng` transcribes requests of `secs` (20 s and
    45 s), with every kernel's launch count read over exactly that run.
    Returns (the launches, x-realtime)."""
    requests = [speechlike(x, SEED + 2 + i) for i, x in enumerate(secs)]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    whisper._decode_flat_ro.calls = whisper._decode_flat_ro.layers = 0
    with counting_prefills(whisper, eng.cfg) as prefills:
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
    check(launches["quantize_heads_kv"] == n_layer * windows,
          "K3 ran once (K and V) for every decoder layer and window")
    check_decode_launches(launches, whisper._decode_flat_ro.calls, n_layer,
                          flat_layers=whisper._decode_flat_ro.layers)
    if "mm_w8a16" in launches:
        check_w8a16_launches(launches, eng.params, n_layer,
                             whisper._decode_flat_ro.calls, prefills["long"],
                             windows)
    return launches, audio_s / wall


def busy_steps(srv, n_busy: int, seed: int, unit: str) -> None:
    """Steady state: n_busy fresh 30 s windows prepared and admitted (every
    slot or group busy), then a few step dispatches timed on the host
    clock, then one under a device-only trace: host wall and device busy
    per decode step, the idle share, the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    sids = [srv.open_session() for _ in range(n_busy)]
    for i, sid in enumerate(sids):
        srv.submit_window(sid, speechlike(30.0, seed + i), language="en")
    srv._prepare_many([srv._pending.get_nowait() for _ in sids])
    srv._admit_pending()
    check(len(srv._slots) == n_busy, f"{n_busy} {unit} admitted")
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
    log(f"  {n_busy} busy {unit}: {per_step * 1e3:.2f} ms host wall per "
        f"decode step untraced ({n} dispatches of {srv.inner_steps} steps)")
    if busy == 0:
        log("  serving trace: the profiler saw no device events; device "
            "time not measured")
    else:
        log(f"  traced dispatch of {srv.inner_steps} steps: "
            f"{traced * 1e3:.1f} ms wall, device busy {busy / 1e3:.2f} ms = "
            f"{busy / 1e3 / srv.inner_steps:.2f} ms/step, device idle share "
            f"{1 - busy / 1e6 / traced:.3f}")
        # The ten longest, then the port's own kernels among the rest.
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
        for name, us in ranked[:10] + [
                (n, us) for n, us in ranked[10:]
                if n.startswith("void (anonymous namespace)::")]:
            log(f"    {us / busy:6.1%}  {us / 1e3:8.2f} ms  {name[:100]}")


def phase_serving(eng, longform, whisper, counters, n_layer,
                  int8_self_cache=False, beam_size=None):
    """The serving path: make_server (8 slots) on the engine's weights
    (with an int8 self-cache if asked), transcribe_files on 8 requests of
    5-45 s, with every kernel's launch count read over exactly that run.
    Then 8 fresh windows fill the slots and a few steps run at 8 busy
    slots: timed on the host clock, then under a device-only trace (busy
    time, idle share). With beam_size (phase 4e): a BeamEngineServer of
    BEAM_GROUPS groups on BEAM_SECS, its state_bytes beside what it
    allocated, K4's beam-mode launches held to 32 x its grouped beam
    steps. Returns the launches and the decoder calls that wrote the
    self-cache (language detection's run on a bf16 cache of its own
    excepted)."""
    from openhush_tpu_torch.models.whisper import decoding
    from openhush_tpu_torch.runtime import beam_batcher
    from openhush_tpu_torch.runtime.beam_server import BeamEngineServer
    cfg, params, tok = eng.cfg, eng.params, eng.tokenizer
    beam = beam_size is not None
    secs, n_slots = ((BEAM_SECS, BEAM_GROUPS) if beam
                     else (SERVE_SECS, SERVE_SLOTS))
    unit = "beam groups" if beam else "slots"
    srv = longform.make_server(cfg, params, tok, n_files=len(secs),
                               n_slots=n_slots, beam_size=beam_size,
                               max_new_tokens=MAX_NEW_TOKENS,
                               dtype=torch.bfloat16, temperatures=(0.0,),
                               int8_self_cache=int8_self_cache)
    check(srv.n_slots == n_slots and isinstance(srv, BeamEngineServer) == beam,
          f"the budgeter kept {n_slots} {unit}")
    st = srv.state
    if beam:
        allocated = sum(t.numel() * t.element_size()
                        for t in vars(st).values() if torch.is_tensor(t))
        sb = beam_batcher.state_bytes(
            cfg, n_slots, beam_size=beam_size, dtype=torch.bfloat16,
            max_len=st.tokens.shape[2], audio_ctx=srv.audio_ctx,
            int8_self_cache=int8_self_cache)
        log(f"  beam server: {n_slots} groups x {beam_size} beams, "
            f"{st.tokens.shape[2]}-row caches: state_bytes "
            f"{sb / 2**20:.2f} MiB, allocated {allocated / 2**20:.2f} MiB")
        check(sb == allocated, "state_bytes == the state's allocation")
    check((st.cache_k.dtype == torch.int8) == int8_self_cache,
          "the server's self-cache dtype")
    if int8_self_cache:
        # The self-cache's bytes against a bf16 one of the same shape, and
        # one slot's at the one-shot engine's 448 rows.
        L, B, T, HD = st.cache_k.shape
        H = st.cache_ks.shape[-1]
        ours = sum(t.numel() * t.element_size() for t in (
            st.cache_k, st.cache_v, st.cache_ks, st.cache_vs))
        log(f"  int8 self-cache at {B} rows x {T}: {ours / 1e6:.2f} MB"
            f" (bf16: {2 * L * B * T * HD * 2 / 1e6:.2f} MB); a slot at 448 "
            f"rows: {2 * L * 448 * HD / 1e6:.2f} MB of levels + "
            f"{2 * L * 448 * H * 4 / 1e6:.2f} MB of scales (bf16: "
            f"{2 * L * 448 * HD * 2 / 1e6:.2f} MB)")
    requests = [speechlike(s, SEED + 20 + i) for i, s in enumerate(secs)]
    # Count the cross-KV computations (one K3 launch a layer each) and the
    # language detections (a flat decoder call on a bf16 cache of its own).
    calls = {"xkv": 0, "detect": 0}
    xkv_fn, detect_fn = (whisper.compute_cross_kv_quant,
                         decoding.detect_language_logits)

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    whisper._decode_flat_ro.calls = whisper._decode_flat_ro.layers = 0
    whisper.decode_beam_step.calls = 0
    whisper.compute_cross_kv_quant = counted("xkv", xkv_fn)
    decoding.detect_language_logits = counted("detect", detect_fn)
    try:
        with counting_prefills(whisper, cfg) as prefills:
            t0 = time.monotonic()
            results = longform.transcribe_files(srv, requests,
                                                language="auto")
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        whisper.compute_cross_kv_quant = xkv_fn
        decoding.detect_language_logits = detect_fn
    launches = {fn.__name__: fn.launches for fn in counters}
    flat_calls = whisper._decode_flat_ro.calls
    beam_calls = whisper.decode_beam_step.calls
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
        f"({srv.inner_steps} steps each, x{srv.deep_factor} when deep"
        + (f"; {beam_calls} grouped beam steps" if beam else "")
        + f"); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; launches {launches}")
    check(launches["log_mel_energies"] >= 1
          and launches["flash_attention"] >= n_layer
          and launches["quantize_heads_kv"] >= n_layer,
          "K1-K3 ran in the server's window preparation")
    writes = flat_calls - calls["detect"] + beam_calls
    k3 = (writes, calls["xkv"]) if int8_self_cache else None
    if beam:
        check_beam_launches(launches, flat_calls, beam_calls, n_layer, k3)
    else:
        check_decode_launches(launches, flat_calls, n_layer, k3,
                              flat_layers=whisper._decode_flat_ro.layers)
    if "mm_w8a16" in launches:
        check_w8a16_launches(launches, params, n_layer,
                             flat_calls + beam_calls, prefills["long"],
                             calls["xkv"])

    busy_steps(srv, n_slots, SEED + 40, unit)
    return launches, writes


# The reference AudioConfig's defaults (openhush_tpu/utils/config.py), which
# build_preprocess reads by attribute: normalization and the limiter on.
AUDIO_DEFAULTS = dict(
    normalization_enabled=True, normalization_target_db=-20.0,
    compression_enabled=False, compression_threshold_db=-20.0,
    compression_ratio=4.0, compression_attack_ms=5.0,
    compression_release_ms=50.0, compression_makeup_gain_db=0.0,
    limiter_enabled=True, limiter_ceiling_db=-1.0, limiter_release_ms=50.0,
    noise_reduction_enabled=False, noise_reduction_strength=1.0)
AUDIO_ALL_ON = dict(AUDIO_DEFAULTS, compression_enabled=True,
                    noise_reduction_enabled=True)
AUDIO_FRONT_SECS = (5.0, 12.0, 20.0, 30.0)   # the server run's requests
# card vs CPU: fp32 matmuls (cuBLAS against the CPU's) and the last bit of
# exp, log10 and pow; the recurrences are the same operations.
PRE_TOL = 1e-4
GATE_TOL = 1e-5
# The stateful chain's card-vs-CPU windows (every stage on), in seconds.
PRE_STATE_SECS = 15.0


def gated_speech(secs: float = 45.0, seed: int = SEED + 70) -> np.ndarray:
    """Speech-like stretches between near silences (1e-3 noise)."""
    rng = np.random.default_rng(seed)
    parts, on, total = [], False, 0.0
    for dur in (3.0, 6.0, 4.0, 10.0, 5.0, 8.0, 9.0):
        dur = min(dur, secs - total)
        parts.append(speechlike(dur, seed + len(parts)) if on else
                     (1e-3 * rng.standard_normal(int(16000 * dur))
                      ).astype(np.float32))
        on, total = not on, total + dur
    return np.concatenate(parts)


def host_and_device(fn, n: int):
    """Host wall per call (the calls end in a host sync or get one) and
    device busy per call from a device-only trace of n more."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy, _ = device_time(prof)
    return wall * 1e3, (busy / 1e3 / n if busy else None)


def threshold_with_margin(probs):
    """A threshold in the widest gap between the middle 80% of `probs`
    (the CPU engine's), and half that gap: segments on the card equal the
    CPU's if every card probability is within that margin of the CPU's."""
    p = np.sort(np.asarray(probs))
    lo, hi = np.quantile(p, 0.1), np.quantile(p, 0.9)
    mid = p[(p >= lo) & (p <= hi)]
    gaps = np.diff(mid)
    i = int(np.argmax(gaps))
    return float((mid[i] + mid[i + 1]) / 2), float(gaps[i] / 2)


def phase_audio_front(eng, longform, dsp, denoise, daemon, vad, silero,
                      wakeword, counters):
    """The daemon's audio front on the card: build_preprocess (default
    config on one 30 s window, every stage on over two consecutive 15 s
    ones) against the same calls on the CPU (plain versions); a server
    with the preprocess (every stage on) on 4 requests of 5-30 s, its DSP
    launches counted, no "preprocess failed" warning, its tokens equal to
    a plain server's fed the preprocessed audio; the VAD engines (energy,
    gru, Silero) into VadState and the wake-word detector on 45 s of
    speech-like audio with silences, card against CPU; host wall and device
    time per VAD chunk, wake-word chunk, 30 s preprocess, and rnn_gains on
    500 frames. Returns the DSP kernels' launches in the server run."""
    import logging
    import types
    from openhush_tpu_torch.runtime import server as server_mod
    dev = torch.device("cuda")
    cfgs = {"default": types.SimpleNamespace(**AUDIO_DEFAULTS),
            "all stages": types.SimpleNamespace(**AUDIO_ALL_ON)}
    windows = [speechlike(30.0, SEED + 60), speechlike(30.0, SEED + 61)]
    for label, cfg in cfgs.items():
        card = daemon.build_preprocess(cfg, device=dev)
        cpu = daemon.build_preprocess(cfg, device="cpu")
        # The default chain carries no state: one 30 s window is enough.
        # Every stage on carries denoise's state: two consecutive windows,
        # cut to their first PRE_STATE_SECS (depth cuts: the CPU's plain
        # loops take up to ~0.75 s a second of audio).
        for i, w in enumerate(
                [w[:int(16000 * PRE_STATE_SECS)] for w in windows]
                if cfg.noise_reduction_enabled else windows[:1]):
            y = card(w)
            t0 = time.perf_counter()
            y_cpu = cpu(w)
            cpu_s = time.perf_counter() - t0
            err = float(np.abs(y - y_cpu).max())
            log(f"  preprocess ({label}), {len(w) / 16000:.0f} s window "
                f"{i + 1} (state carried): card vs CPU max_abs_err "
                f"{err:.3e} (tolerance {PRE_TOL}); peak "
                f"{np.abs(y).max():.4f}; the CPU's plain "
                f"versions took {cpu_s:.1f} s of host wall")
            check(err <= PRE_TOL and y.shape == w.shape
                  and bool(np.isfinite(y).all()),
                  f"preprocess ({label}) card vs CPU, window {i + 1}")

    # The server with the preprocess (every stage on) on the engine's
    # weights; each window's preprocessed audio is kept for the plain
    # server.
    requests = [speechlike(s, SEED + 62 + i)
                for i, s in enumerate(AUDIO_FRONT_SECS)]
    pre = daemon.build_preprocess(cfgs["all stages"], device=dev)
    seen = []

    def recorded(audio):
        out = pre(audio)
        seen.append(out)
        return out

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    def make(preprocess):
        return longform.make_server(
            eng.cfg, eng.params, eng.tokenizer, n_files=len(requests),
            n_slots=len(requests), max_new_tokens=MAX_NEW_TOKENS,
            dtype=torch.bfloat16, temperatures=(0.0,), preprocess=preprocess)

    dsp_fns = (dsp.follow_envelope, dsp.limiter_gain, denoise.noise_floor)
    serial_fns = [dsp.follow_envelope_serial, dsp.limiter_gain_serial]
    capture = Capture()
    server_log = logging.getLogger(server_mod.__name__)
    server_log.addHandler(capture)
    try:
        srv = make(recorded)
        torch.cuda.synchronize()
        for fn in counters + list(dsp_fns) + serial_fns:
            fn.launches = 0
        t0 = time.monotonic()
        tokens = serve_windows(srv, requests)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {fn.__name__: fn.launches for fn in counters + list(dsp_fns)}
    finally:
        server_log.removeHandler(capture)
    failures = srv.preprocess_failures
    del srv
    n = len(requests)
    log(f"  server with the preprocess (every stage on): {n} windows of "
        f"{AUDIO_FRONT_SECS} s in {wall:.2f} s wall; launches {launches}; "
        f"warnings logged: {capture.messages}")
    check(len(seen) == n, "the preprocess ran once a window")
    check(all(launches[fn.__name__] == n for fn in dsp_fns),
          "each DSP kernel ran once a window (denoise's floor, the "
          "compressor's envelope, the limiter's gain)")
    check(all(fn.launches == 0 for fn in serial_fns),
          "the path never took the serial walk (oh_*_serial)")
    check(not any("preprocess failed" in m for m in capture.messages),
          "no 'preprocess failed' warning: the server did not fall back to "
          "the raw audio")
    check(failures == 0, f"preprocess_failures == 0 (phase 4c-audio): "
          f"{failures}")
    check(launches["log_mel_energies"] >= 1 and launches["flash_attention"] >= 32
          and launches["quantize_heads_kv"] >= 32
          and launches["attend_decode"] > 0
          and launches["attend_decode_pipelined"] > 0,
          "K1-K5 ran in the server run")
    plain = serve_windows(make(None), seen)
    log(f"  tokens: {[len(t) for t in tokens]} per window; a plain server "
        f"fed the preprocessed audio: "
        f"{'equal' if plain == tokens else 'DIFFERENT'}")
    check(plain == tokens, "the preprocess server's tokens == a plain "
          "server's on the preprocessed audio")

    # The gates on 45 s of speech-like audio with silences: each engine on
    # the card and on the CPU, with the same weights.
    audio = gated_speech()
    vad_chunks = [audio[i:i + vad.CHUNK_SIZE]
                  for i in range(0, len(audio), vad.CHUNK_SIZE)]
    gen = torch.Generator().manual_seed(SEED)
    gru_cpu = vad.gru_vad_init_params(gen, device="cpu")
    sil_cpu = silero.init_params(torch.Generator().manual_seed(SEED + 1),
                                 device="cpu")

    def on(params):
        return {k: v.to(dev) for k, v in params.items()}

    engines = {
        "energy": (lambda d: vad.VadEngine(kind="energy", device=d)),
        "gru": (lambda d: vad.VadEngine(
            kind="gru", device=d, params=gru_cpu if d == "cpu" else on(gru_cpu))),
        "silero": (lambda d: silero.SileroVad(
            sil_cpu if d == "cpu" else on(sil_cpu), device=d)),
    }
    timings = {}
    for name, make_engine in engines.items():
        probs = {}
        for d in (dev, "cpu"):
            engine = make_engine(d)
            probs[d] = [engine.process(c).probability for c in vad_chunks]
        err = float(np.abs(np.subtract(probs[dev], probs["cpu"])).max())
        thr, margin = ((0.5, float(np.abs(np.asarray(probs["cpu"]) - 0.5).min()))
                       if name == "energy"
                       else threshold_with_margin(probs["cpu"]))
        segs = {}
        for d in (dev, "cpu"):
            st = vad.VadState(vad.VadStateConfig(threshold=thr))
            segs[d] = [s for s in (st.update(vad.VadResult(p, p >= thr),
                                             vad.CHUNK_SIZE)
                                   for p in probs[d]) if s is not None]
        same = ([(s.start, s.end) for s in segs[dev]]
                == [(s.start, s.end) for s in segs["cpu"]])
        log(f"  VAD {name}: {len(vad_chunks)} chunks, probabilities card vs "
            f"CPU max_abs_err {err:.3e} (tolerance {GATE_TOL}); threshold "
            f"{thr:.6f}, the CPU's probabilities at least {margin:.3e} from "
            f"it; segments {len(segs[dev])} card, {len(segs['cpu'])} CPU, "
            f"{'equal' if same else 'DIFFERENT'}")
        check(err <= GATE_TOL, f"VAD {name} probabilities card vs CPU")
        check(margin > err, f"VAD {name}: the threshold's margin exceeds the "
              "card-vs-CPU error")
        check(same, f"VAD {name} segments card vs CPU")
        if name == "energy":
            check(len(segs["cpu"]) >= 2, "the energy gate found the speech")
        engine = make_engine(dev)
        timings[f"VAD {name} chunk (32 ms)"] = host_and_device(
            lambda: engine.process(vad_chunks[len(vad_chunks) // 2]), 50)

    ww_gen = torch.Generator().manual_seed(SEED + 2)
    emb = wakeword.init_embedding_params(ww_gen, device="cpu")
    cls = wakeword.init_classifier_params(ww_gen, device="cpu")
    dets = {dev: wakeword.WakeWordDetector(emb_params=on(emb),
                                           cls_params=on(cls), device=dev),
            "cpu": wakeword.WakeWordDetector(emb_params=emb, cls_params=cls,
                                             device="cpu")}
    step = wakeword.CHUNK_SAMPLES
    scores = {d: [det.process(audio[i:i + step])
                  for i in range(0, len(audio), step)]
              for d, det in dets.items()}
    warm = [(a, b) for a, b in zip(scores[dev], scores["cpu"])
            if a is not None or b is not None]
    check(all(a is not None and b is not None for a, b in warm),
          "wake word: card and CPU warm at the same chunk")
    err = max(abs(a - b) for a, b in warm)
    log(f"  wake word: {len(scores[dev])} chunks, {len(warm)} scores, card "
        f"vs CPU max_abs_err {err:.3e} (tolerance {GATE_TOL})")
    check(err <= GATE_TOL and len(warm) > 0, "wake-word scores card vs CPU")
    det = dets[dev]
    timings["wake-word chunk (80 ms)"] = host_and_device(
        lambda: det.process(audio[:step]), 50)

    for label, cfg in cfgs.items():
        card = daemon.build_preprocess(cfg, device=dev)
        timings[f"preprocess, 30 s window ({label})"] = host_and_device(
            lambda: card(windows[0]), 5)
    rnn = denoise.init_rnn_params(torch.Generator(device=dev).manual_seed(SEED),
                                  device=dev)
    band = torch.rand(500, denoise.N_BANDS, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    st = denoise.init_state(dev)
    timings["rnn_gains, 500 frames (eager)"] = host_and_device(
        lambda: denoise.rnn_gains(rnn, band, st)[0].sum().item(), 2)
    for what, (wall, busy) in timings.items():
        log(f"  {what}: host wall {wall:.3f} ms, device busy "
            + (f"{busy:.4f} ms" if busy is not None else "not measured "
               "(the profiler saw no device events)"))
    return {fn.__name__: launches[fn.__name__] for fn in dsp_fns}


# ---------------------------------------------------------------------------
# .onnx graphs with the published aux models' signatures (written here: no
# checkpoint is downloaded), for phase_onnx and tests/test_torch_onnx.py
# ---------------------------------------------------------------------------

def _onnx_model(nodes, inits, inputs, outputs):
    from openhush_tpu_torch.utils.onnx_io import (OnnxGraph, OnnxModel,
                                                  OnnxValueInfo)
    return OnnxModel(OnnxGraph(
        nodes=nodes, initializers=inits,
        inputs=[OnnxValueInfo(n, t, s) for n, t, s in inputs],
        outputs=[OnnxValueInfo(n, 1, ()) for n in outputs]))


def silero_v5_graph(rng: np.random.Generator):
    """Silero VAD v5's signature and widths, random weights: (input
    [1, 512], state [2, 1, 128], sr int64) → (output [1, 1], stateN
    [2, 1, 128]). An If on sr == 16000 picks the STFT basis (a subgraph
    initializer), then: reflect pad 64, the STFT as a stride-128 Conv
    ([258, 1, 256] hann-windowed DFT rows), magnitudes, the four encoder
    convolutions (129→128→64→64→128, k3, strides 1, 2, 2, 1) with ReLU, an
    LSTM cell (hidden 128) on the state's h and c, a 1x1 Conv, sigmoid and
    a mean."""
    from openhush_tpu_torch.utils.onnx_io import OnnxGraph, OnnxNode, \
        OnnxValueInfo
    n = np.arange(256)
    ang = 2 * np.pi * np.outer(np.arange(129), n) / 256
    basis = (np.concatenate([np.cos(ang), -np.sin(ang)])
             * np.hanning(257)[:-1]).astype(np.float32)[:, None, :]

    def g(*shape):
        fan = int(np.prod(shape[1:]))
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def branch(b):
        return OnnxGraph(nodes=[OnnxNode("Identity", ["b"], ["basis"])],
                         initializers={"b": b}, inputs=[],
                         outputs=[OnnxValueInfo("basis")])

    H = 128
    inits = {
        "pads": np.asarray([0, 0, 0, 64], np.int64),
        "sr16k": np.asarray(16000, np.int64),
        "zero": np.asarray(0, np.int64), "one": np.asarray(1, np.int64),
        "w0": g(128, 129, 3), "b0": g(128, 1)[:, 0],
        "w1": g(64, 128, 3), "b1": g(64, 1)[:, 0],
        "w2": g(64, 64, 3), "b2": g(64, 1)[:, 0],
        "w3": g(128, 64, 3), "b3": g(128, 1)[:, 0],
        "W": g(1, 4 * H, H), "R": g(1, 4 * H, H),
        "B": (0.1 * rng.standard_normal((1, 8 * H))).astype(np.float32),
        "wo": g(1, H, 1), "bo": np.zeros(1, np.float32),
    }
    N = OnnxNode
    conv = [N("Conv", ["mag", "w0", "b0"], ["c0"],
              attrs={"kernel_shape": [3], "pads": [1, 1]}),
            N("Relu", ["c0"], ["r0"]),
            N("Conv", ["r0", "w1", "b1"], ["c1"], attrs={
                "kernel_shape": [3], "pads": [1, 1], "strides": [2]}),
            N("Relu", ["c1"], ["r1"]),
            N("Conv", ["r1", "w2", "b2"], ["c2"], attrs={
                "kernel_shape": [3], "pads": [1, 1], "strides": [2]}),
            N("Relu", ["c2"], ["r2"]),
            N("Conv", ["r2", "w3", "b3"], ["c3"],
              attrs={"kernel_shape": [3], "pads": [1, 1]}),
            N("Relu", ["c3"], ["r3"])]
    nodes = [
        N("Equal", ["sr", "sr16k"], ["is16k"]),
        N("If", ["is16k"], ["basis"], attrs={
            "then_branch": branch(basis), "else_branch": branch(0.5 * basis)}),
        N("Pad", ["input", "pads"], ["padded"], attrs={"mode": "reflect"}),
        N("Unsqueeze", ["padded"], ["x3"], attrs={"axes": [1]}),
        N("Conv", ["x3", "basis"], ["spec"],
          attrs={"kernel_shape": [256], "strides": [128]}),
        N("Slice", ["spec", "s0", "s129", "ax1"], ["re"]),
        N("Slice", ["spec", "s129", "s258", "ax1"], ["im"]),
        N("Mul", ["re", "re"], ["re2"]), N("Mul", ["im", "im"], ["im2"]),
        N("Add", ["re2", "im2"], ["pow"]), N("Sqrt", ["pow"], ["mag"]),
        *conv,
        N("Transpose", ["r3"], ["seq"], attrs={"perm": [2, 0, 1]}),
        N("Gather", ["state", "zero"], ["h"], attrs={"axis": 0}),
        N("Gather", ["state", "one"], ["c"], attrs={"axis": 0}),
        N("Unsqueeze", ["h"], ["h0"], attrs={"axes": [0]}),
        N("Unsqueeze", ["c"], ["c0"], attrs={"axes": [0]}),
        N("LSTM", ["seq", "W", "R", "B", "", "h0", "c0"],
          ["Y", "Yh", "Yc"], attrs={"hidden_size": H}),
        N("Relu", ["Yh"], ["hr"]),
        N("Transpose", ["hr"], ["hc"], attrs={"perm": [1, 2, 0]}),
        N("Conv", ["hc", "wo", "bo"], ["logit"], attrs={"kernel_shape": [1]}),
        N("Sigmoid", ["logit"], ["p"]),
        N("ReduceMean", ["p"], ["output"], attrs={"axes": [2],
                                                  "keepdims": 0}),
        N("Concat", ["Yh", "Yc"], ["stateN"], attrs={"axis": 0}),
    ]
    inits.update({"s0": np.asarray([0], np.int64),
                  "s129": np.asarray([129], np.int64),
                  "s258": np.asarray([258], np.int64),
                  "ax1": np.asarray([1], np.int64)})
    return _onnx_model(nodes, inits, [("input", 1, (1, 512)),
                                      ("state", 1, (2, 1, H)),
                                      ("sr", 7, ())],
                       ["output", "stateN"])


def wakeword_graphs(rng: np.random.Generator):
    """openWakeWord's two ONNX stages at their I/O widths, random weights:
    the embedding ([1, 76, 32, 1] mel image → [1, 1, 1, 96]: 3x3 Convs
    24 → 48 → 96 with LeakyReLU, BatchNormalization, 2x2 MaxPools and a
    global max) and a per-word classifier ([1, 16, 96] → [1, 1]: Flatten,
    Gemm 1536 → 128, LayerNormalization, ReLU, Gemm → 1, sigmoid)."""
    from openhush_tpu_torch.utils.onnx_io import OnnxNode as N

    def g(*shape, fan=None):
        fan = fan or int(np.prod(shape[1:]))
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def bn(c):
        return {"bn_s": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                "bn_b": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "bn_m": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "bn_v": (0.5 + rng.random(c)).astype(np.float32)}

    same = {"kernel_shape": [3, 3], "auto_pad": "SAME_UPPER"}
    pool = {"kernel_shape": [2, 2], "strides": [2, 2]}
    emb = _onnx_model([
        N("Transpose", ["input_1"], ["x"], attrs={"perm": [0, 3, 1, 2]}),
        N("Conv", ["x", "w1", "b1"], ["c1"], attrs=same),
        N("LeakyRelu", ["c1"], ["a1"], attrs={"alpha": 0.2}),
        N("MaxPool", ["a1"], ["p1"], attrs=pool),
        N("Conv", ["p1", "w2", "b2"], ["c2"], attrs=same),
        N("BatchNormalization", ["c2", "bn_s", "bn_b", "bn_m", "bn_v"],
          ["n2"], attrs={"epsilon": 1e-3}),
        N("LeakyRelu", ["n2"], ["a2"], attrs={"alpha": 0.2}),
        N("MaxPool", ["a2"], ["p2"], attrs=pool),
        N("Conv", ["p2", "w3", "b3"], ["c3"], attrs={
            "kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}),
        N("Relu", ["c3"], ["a3"]),
        N("GlobalMaxPool", ["a3"], ["gp"]),
        N("Transpose", ["gp"], ["out"], attrs={"perm": [0, 2, 3, 1]}),
    ], {"w1": g(24, 1, 3, 3), "b1": g(24, 1)[:, 0],
        "w2": g(48, 24, 3, 3), "b2": g(48, 1)[:, 0],
        "w3": g(96, 48, 3, 3), "b3": g(96, 1)[:, 0], **bn(48)},
        [("input_1", 1, (1, 76, 32, 1))], ["out"])
    cls_m = _onnx_model([
        N("Flatten", ["x"], ["f"], attrs={"axis": 1}),
        N("Gemm", ["f", "w1", "b1"], ["h"]),
        N("LayerNormalization", ["h", "ln_s", "ln_b"], ["hn"],
          attrs={"axis": -1, "epsilon": 1e-5}),
        N("Relu", ["hn"], ["hr"]),
        N("Gemm", ["hr", "w2", "b2"], ["o"], attrs={"transB": 1}),
        N("Sigmoid", ["o"], ["score"]),
    ], {"w1": g(1536, 128, fan=1536), "b1": np.zeros(128, np.float32),
        "ln_s": np.ones(128, np.float32), "ln_b": np.zeros(128, np.float32),
        "w2": g(1, 128), "b2": np.asarray([0.1], np.float32)},
        [("x", 1, (1, 16, 96))], ["score"])
    return emb, cls_m


# ---------------------------------------------------------------------------
# The aux models and the rest of training
# ---------------------------------------------------------------------------

SILERO_CHUNKS = 300          # 9.6 s of gated speech, 32 ms a chunk
WAKE_CHUNKS = 60             # 4.8 s, 80 ms a chunk


def phase_onnx(vad, wakeword, onnx_io, tmp):
    """The ONNX executor on the card: a Silero-v5-signature graph and the
    two wake-word stages at their published widths (written here, random
    weights), card against CPU within GATE_TOL, and per-chunk costs."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 75)
    sil_path = os.path.join(tmp, "silero_vad.onnx")
    onnx_io.save(silero_v5_graph(rng), sil_path)
    emb, cls_m = wakeword_graphs(rng)
    ep, cp = os.path.join(tmp, "emb.onnx"), os.path.join(tmp, "cls.onnx")
    onnx_io.save(emb, ep)
    onnx_io.save(cls_m, cp)

    class Cfg:
        engine, threshold, model_path = "silero", 0.5, sil_path

    engines = {d: vad.create_engine(Cfg(), device=d) for d in (dev, "cpu")}
    check(all(isinstance(e, vad.OnnxSileroVad) for e in engines.values())
          and engines[dev].device.type == "cuda",
          "create_engine built OnnxSileroVad on the card")
    audio = gated_speech()
    chunks = [audio[i * vad.CHUNK_SIZE:(i + 1) * vad.CHUNK_SIZE]
              for i in range(SILERO_CHUNKS)]
    probs = {d: [e.process(c).probability for c in chunks]
             for d, e in engines.items()}
    err = float(np.abs(np.subtract(probs[dev], probs["cpu"])).max())
    log(f"  ONNX Silero (v5 signature): {SILERO_CHUNKS} chained chunks, "
        f"probabilities {min(probs[dev]):.4f}-{max(probs[dev]):.4f}, card vs "
        f"CPU max_abs_err {err:.3e} (tolerance {GATE_TOL})")
    check(err <= GATE_TOL and len(set(probs[dev])) > 1,
          "ONNX Silero probabilities card vs CPU")
    dets = {d: wakeword.WakeWordDetector.from_onnx(ep, cp, device=d)
            for d in (dev, "cpu")}
    step = wakeword.CHUNK_SAMPLES
    scores = {d: [det.process(audio[i * step:(i + 1) * step])
                  for i in range(WAKE_CHUNKS)] for d, det in dets.items()}
    warm = [(a, b) for a, b in zip(scores[dev], scores["cpu"])
            if a is not None or b is not None]
    check(warm and all(a is not None and b is not None for a, b in warm),
          "ONNX wake word: card and CPU warm at the same chunk")
    err = max(abs(a - b) for a, b in warm)
    log(f"  ONNX wake word: {WAKE_CHUNKS} chunks, {len(warm)} scores, card "
        f"vs CPU max_abs_err {err:.3e} (tolerance {GATE_TOL})")
    check(err <= GATE_TOL, "ONNX wake-word scores card vs CPU")
    card, det = engines[dev], dets[dev]
    timings = {"ONNX Silero chunk (32 ms)": host_and_device(
                   lambda: card.process(chunks[100]), 50),
               "ONNX wake-word chunk (80 ms)": host_and_device(
                   lambda: det.process(audio[:step]), 50)}
    for what, (wall, busy) in timings.items():
        log(f"  {what}: host wall {wall:.3f} ms, device busy "
            + (f"{busy:.4f} ms" if busy is not None else "not measured "
               "(the profiler saw no device events)"))
    return timings


def conversation(sp, secs: float, seed: int) -> np.ndarray:
    """Two synthetic voices (training/speaker.py) taking turns of 1.5-3 s
    with 0.3-0.8 s gaps, `secs` long."""
    rng = np.random.default_rng(seed)
    bank = sp.synth_speaker_bank(rng, 2)
    n = int(secs * 16000)
    out, t, turn = np.zeros(n, np.float32), 0, 0
    while t < n - 8000:
        length = min(int(rng.uniform(1.5, 3.0) * 16000), n - t)
        out[t:t + length] = sp.synth_utterance(rng, bank[turn % 2], length)
        t += length + int(rng.uniform(0.3, 0.8) * 16000)
        turn += 1
    return out


def phase_diarization(diarization, der, sp, tmp):
    """DiarizationEngine.from_local() (the packaged checkpoints) on 45 s of
    two synthetic speakers in 5 s chunks, card against CPU: embeddings,
    segments and speakers; DER on three synthetic meetings (card and CPU
    equal); host wall per chunk; fifty train_embedder steps on the card."""
    dev = torch.device("cuda")
    env = os.environ.get("OPENHUSH_MODEL_DIR")
    os.environ["OPENHUSH_MODEL_DIR"] = os.path.join(tmp, "models")
    try:
        engines = {d: diarization.DiarizationEngine.from_local(device=d)
                   for d in (dev, "cpu")}
    finally:
        if env is None:
            del os.environ["OPENHUSH_MODEL_DIR"]
        else:
            os.environ["OPENHUSH_MODEL_DIR"] = env
    check(all(e.seg_params is not None for e in engines.values()),
          "from_local loaded the packaged segmentation net")
    embs = {d: [] for d in engines}
    for d, e in engines.items():
        embed = e.embed
        e.embed = lambda a, embed=embed, out=embs[d]: (
            out.append(embed(a)) or out[-1])
    audio = conversation(sp, 45.0, SEED + 85)
    win = 5 * 16000
    segs, walls = {}, []
    for d, e in engines.items():
        segs[d] = []
        for s0 in range(0, len(audio), win):
            t0 = time.perf_counter()
            segs[d] += [(s.start_secs, s.end_secs, s.speaker_id)
                        for s in e.diarize_chunk(audio[s0:s0 + win],
                                                 offset_secs=s0 / 16000)]
            if d == dev:
                walls.append((time.perf_counter() - t0) * 1e3)
    err = max((float(np.abs(a - b).max())
               for a, b in zip(embs[dev], embs["cpu"])), default=0.0)
    same = segs[dev] == segs["cpu"]
    n_spk = engines[dev].clusterer.n_speakers
    log(f"  diarization, 45 s of two synthetic speakers in 5 s chunks: "
        f"{len(segs[dev])} segments, {n_spk} speakers; card vs CPU: "
        f"{len(embs[dev])} embeddings, max_abs_err {err:.3e} (tolerance "
        f"{GATE_TOL}), segments and speakers "
        + ("equal" if same else "DIFFERENT"))
    check(len(embs[dev]) == len(embs["cpu"]) > 0 and err <= GATE_TOL,
          "diarization embeddings card vs CPU")
    check(same and n_spk == engines["cpu"].clusterer.n_speakers,
          "diarization segments and speakers card vs CPU")
    log(f"  diarization host wall a 5 s chunk (card): median "
        f"{float(np.median(walls)):.2f} ms, max {max(walls):.2f} ms over "
        f"{len(walls)} chunks")
    results = {}
    for d, e in engines.items():
        e.reset()
        t0 = time.perf_counter()
        results[d] = der.evaluate_synthetic_meetings(e, n_meetings=3,
                                                     seed=SEED + 86,
                                                     secs=20.0)
        if d == dev:
            der_wall = time.perf_counter() - t0
    log(f"  DER, three synthetic meetings (20 s each, 2-4 speakers, 5 s "
        f"chunks): card {results[dev]}; CPU DER {results['cpu'].der:.4f}; "
        f"{der_wall:.2f} s wall on the card")
    check(math.isfinite(results[dev].der)
          and results[dev].der == results["cpu"].der,
          "DER card == CPU")
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp.train_embedder(seed=SEED, n_speakers=8, steps=50, batch=24,
                      device=dev, losses=losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    log(f"  train_embedder on the card: 50 steps (batch 24, 8 speakers) in "
        f"{wall:.2f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
        f"the first ten {first:.4f}, of the last ten {last:.4f})")
    check(len(losses) == 50 and all(map(math.isfinite, losses))
          and last < first, "the embedder's training loss falls")
    return {"chunk_ms": float(np.median(walls)), "der": results[dev].der}


M2M_SRC = 32                 # source tokens a row, EOS included
M2M_CPU_STEPS = 16


def phase_m2m100(m2m100, train):
    """M2M-100 418M at its published widths (random weights, fp32): greedy
    translation of 2 rows of 32 source tokens to MAX_NEW_TOKENS (256), the
    card's first row against the CPU's over 16 steps, wall per token,
    device busy per decode step and peak memory."""
    dev = torch.device("cuda")
    cfg = m2m100.CONFIGS["418M"]
    check((cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_enc_layers,
           cfg.n_dec_layers, cfg.ffn_dim) == (128112, 1024, 16, 12, 12, 4096),
          "M2M-100 418M's published widths")
    t0 = time.perf_counter()
    cpu = m2m100.init_params(cfg, torch.Generator().manual_seed(SEED + 80),
                             device="cpu")
    params = to_device(cpu, dev)
    n_params = sum(t.numel() for t in train.leaves(cpu))
    log(f"  M2M-100 418M: {n_params / 1e6:.1f}M parameters (fp32, random, "
        f"seed {SEED + 80}) in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 81)
    src = np.concatenate([rng.integers(3, cfg.lang_token_base,
                                       (2, M2M_SRC - 1)),
                          np.full((2, 1), m2m100.EOS)], axis=1)
    src_t = torch.from_numpy(src).to(dev)
    lang = m2m100.lang_token_id(cfg, "de")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = m2m100.greedy_translate(cfg, params, src_t, lang,
                                  max_new=m2m100.MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = out.cpu().numpy()
    steps = int((out != m2m100.PAD).any(axis=0).sum())
    check(out.shape == (2, m2m100.MAX_NEW_TOKENS)
          and ((out >= 0) & (out < cfg.vocab_size)).all() and steps > 0,
          "M2M-100 tokens in range")
    with torch.no_grad():
        ref = m2m100.greedy_translate(cfg, cpu, torch.from_numpy(src[:1]),
                                      lang, max_new=M2M_CPU_STEPS).numpy()
    first = next((j for j in range(M2M_CPU_STEPS)
                  if out[0, j] != ref[0, j]), M2M_CPU_STEPS)
    log(f"  M2M-100 greedy_translate, 2 rows x {M2M_SRC} source tokens -> "
        f"'__de__', {steps} steps (cap {m2m100.MAX_NEW_TOKENS}): {wall:.2f} s "
        f"wall = {wall * 1e3 / steps:.2f} ms a step "
        f"({wall * 1e3 / (2 * steps):.2f} ms a token), peak memory {peak:.2f} GiB; row 0 card vs CPU over "
        f"{M2M_CPU_STEPS} steps: "
        + ("equal" if first == M2M_CPU_STEPS else f"part at step {first}"))
    check(first == M2M_CPU_STEPS, "M2M-100 card tokens == CPU's (row 0, "
          "16 steps)")
    with torch.no_grad():
        feats = m2m100.encode(cfg, params, src_t)
        xkv = m2m100.compute_cross_kv(cfg, params, feats)
        cache = m2m100.init_kv_cache(cfg, 2, max_len=m2m100.MAX_NEW_TOKENS + 2,
                                     device=dev)
        tok = torch.from_numpy(out[:, :1]).to(dev)
        host, dev_ms, busy, by_name = per_call(
            lambda: m2m100.decode(cfg, params, tok, 100, cache, xkv, src_t))
    log(f"  M2M-100 decode step (2 rows, S=1, 12 layers): {host:.2f} ms host "
        f"wall, " + (f"{dev_ms:.3f} ms device busy" if busy else
                     "device time not measured (no device events)"))
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
        log(f"    {us / busy:6.1%}  {kname[:80]}")
    del params
    return {"ms_per_token": wall * 1e3 / (2 * steps), "step_host_ms": host,
            "step_device_ms": dev_ms}


DISTILL_B = 8
DISTILL_GEN = 48
DISTILL_BATCHES = 8
DISTILL_EPOCHS = 6
DISTILL_BUDGET_S = 150.0


def varied_speech(rng: np.random.Generator, secs: float = 30.0
                  ) -> np.ndarray:
    """speechlike() with a random pitch, pitch swing, syllable rate and
    noise level a window."""
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    f0 = rng.uniform(90, 260) + rng.uniform(10, 60) * np.sin(
        2 * np.pi * rng.uniform(0.2, 1.0) * t)
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) * (
        0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    return (x + rng.uniform(0.01, 0.08) * rng.standard_normal(n)
            ).astype(np.float32)


def phase_distill(seng, distill, speculative, decoding, whisper, frontend,
                  counters, n_layer, EngineServer, batcher, get_config,
                  tie_threshold):
    """Distillation of a large-v3-turbo-shaped draft (4 decoder layers, d
    1280) against the large-v3 teacher (bf16, the engine's weights):
    distill_draft on B=8 rows of varied speech-like windows, 48 tokens,
    8 rollout batches (+1 held out), 6 epochs, under a time budget, the
    launches of K1-K5 counted over exactly that run; then the distilled
    draft in the one-shot speculative loop (and the engine's random draft
    beside it) on two held-out windows, tokens held to greedy's up to the
    first near-tie, and in a 1-slot spec server against a plain server."""
    dev = torch.device("cuda")
    cfg, params, tok = seng.cfg, seng.params, seng.tokenizer
    dcfg = get_config("large-v3-turbo")
    check(dcfg.n_text_layer == 4 and dcfg.n_text_state == 1280,
          "the draft is large-v3-turbo-shaped")
    opts = decoding.DecodingOptions(language="en",
                                    max_new_tokens=MAX_NEW_TOKENS)
    prompt = np.tile(np.asarray(tok.sot_sequence("en"), np.int64),
                     (DISTILL_B, 1))
    suppress = decoding.build_suppress_mask(tok, cfg, opts)

    def mel_fn(rng):
        audio = torch.from_numpy(np.stack(
            [varied_speech(rng) for _ in range(DISTILL_B)])).to(dev)
        return frontend.log_mel(audio, cfg.n_mels).float().cpu().numpy()

    flat = whisper._decode_flat_ro
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    flat.calls = flat.layers = 0
    t0 = time.perf_counter()
    draft, stats = distill.distill_draft(
        cfg, params, dcfg, mel_fn, prompt, suppress,
        n_batches=DISTILL_BATCHES, epochs=DISTILL_EPOCHS,
        gen_tokens=DISTILL_GEN, lr=1e-3, seed=SEED + 7,
        time_budget_s=DISTILL_BUDGET_S, log=lambda m: log("  " + m))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  distill_draft: {wall:.2f} s wall, peak memory {peak:.2f} GiB; "
        f"stats {json.dumps(stats)}")
    n_roll = stats["rollout_batches"] + 1
    check(stats["steps"] >= 1 and math.isfinite(stats["heldout_ce"])
          and not stats["heldout_is_train"], "distill_draft stats")
    check(stats["heldout_ce"] < stats["init_heldout_ce"],
          "distillation lowered the held-out CE")
    # K1 a rollout batch; K2 and K3 a layer a batch (and K3 a draft layer
    # for each held-out eval); K4 = K5 = a layer for each flat decoder call
    # (a prefill and 47 steps a batch).
    check(launches["log_mel_energies"] == n_roll
          and launches["flash_attention"] == n_layer * n_roll
          and launches["quantize_heads_kv"] == (n_layer * n_roll
                                                + 2 * dcfg.n_text_layer)
          and flat.calls == DISTILL_GEN * n_roll
          and launches["attend_decode"] == launches["attend_decode_pipelined"]
          == n_layer * flat.calls, f"distill launches {launches}, "
          f"{flat.calls} flat calls")
    out = {"stats": stats, "wall_s": wall, "launches": launches}

    # The one-shot loop on two held-out windows, one at a time: greedy (its
    # filtered top-two margins recorded), the distilled draft, the random
    # draft.
    rng = np.random.default_rng(SEED + 95)
    windows = [varied_speech(rng) for _ in range(2)]
    loop = speculative.speculative_greedy_loop
    ts_filter, eot = decoding._timestamp_filter, tok.special.eot
    drafts = {"distilled draft": (dcfg, draft),
              "random draft": (seng.draft_cfg, seng.draft_params)}
    totals = {name: [0, 0, 0.0] for name in drafts}   # tokens, verifies, s
    for w, audio in enumerate(windows):
        margins = []

        def recording(lg, *a, **k):
            res = ts_filter(lg, *a, **k)
            top2 = res[0].topk(2).values
            margins.append((top2[0] - top2[1]).item())
            return res

        with torch.inference_mode():
            feats = whisper.encode(cfg, params, frontend.log_mel(
                torch.from_numpy(audio).to(dev)[None],
                cfg.n_mels).to(seng.dtype))
            xkv = seng._cross_kv(feats)
            decoding._timestamp_filter = recording
            try:
                g = decoding.decode_greedy(cfg, params, xkv, tok, opts)
            finally:
                decoding._timestamp_filter = ts_filter
            tie = next((j for j, x in enumerate(margins)
                        if x < tie_threshold), len(margins))
            for name, (dc, dp) in drafts.items():
                dxkv = whisper.compute_cross_kv(dc, dp, feats)
                before = loop.verifies
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = speculative.decode_speculative(
                    cfg, params, dc, dp, xkv, dxkv, tok, opts,
                    k_spec=K_ONESHOT)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                P = g.prompt_len
                row, ref = res.tokens[0, P:], g.tokens[0, P:]
                first = next((j for j in range(len(ref))
                              if row[j] != ref[j]), len(ref))
                check(first == len(ref) or first >= tie,
                      f"speculative ({name}), window {w}: tokens == "
                      f"greedy's up to the first near-tie")
                m = emitted(res, MAX_NEW_TOKENS, eot)
                t = totals[name]
                t[0] += m - 1
                t[1] += loop.verifies - before
                t[2] += secs
                log(f"  one-shot speculative, {name}, window {w}: {m} "
                    f"tokens, {loop.verifies - before} verify passes, "
                    f"{secs:.2f} s; tokens "
                    + ("equal greedy's" if first == len(ref) else
                       f"part from greedy's at step {first} (near-tie at "
                       f"{tie})"))
    for name, (m, nv, secs) in totals.items():
        log(f"  one-shot speculative, {name} (K={K_ONESHOT}), 2 held-out "
            f"windows: {m / nv:.2f} tokens a verify (beyond each window's "
            f"first token), {secs:.2f} s wall")
        out[name + "_per_verify"] = m / nv

    # A 1-slot spec server with the distilled draft, against a plain server
    # on the same window, up to the plain server's first near-tie.
    audio = windows[0]
    kw = dict(n_slots=1, inner_steps=8, dtype=torch.bfloat16, tokenizer=tok,
              max_decode_len=128, temperatures=(0.0,), k_spec=K_SPEC)
    margins, choose = [], batcher._choose_tokens

    def recording_choose(lg, st, rows=None):
        top2 = lg.topk(2, dim=-1).values
        margins.append((top2[0, 0] - top2[0, 1]).item())
        return choose(lg, st, rows)

    batcher._choose_tokens = recording_choose
    try:
        [plain] = serve_windows(EngineServer(cfg, params, **kw), [audio])
    finally:
        batcher._choose_tokens = choose
    tie = next((j for j, x in enumerate(margins) if x < tie_threshold),
               len(margins))
    srv = EngineServer(cfg, params, draft=(dcfg, draft), spec_policy="always",
                       **kw)
    t0 = time.perf_counter()
    [got] = serve_windows(srv, [audio])
    wall = time.perf_counter() - t0
    iters = srv.spec_iters
    first = next((j for j in range(min(len(got), len(plain)))
                  if got[j] != plain[j]), min(len(got), len(plain)))
    log(f"  spec server, distilled draft (1 slot, K={K_SPEC}): {len(got)} "
        f"tokens in {iters} iterations = {(len(got) + 1) / iters:.2f} a "
        f"verify, {wall:.2f} s; tokens vs the plain server's: "
        + ("equal" if got == plain else f"part at step {first}"))
    check(iters > 0 and (got == plain or first >= tie),
          "distilled spec server tokens == plain server's up to the first "
          "near-tie")
    out["server_per_verify"] = (len(got) + 1) / iters
    return out


def check_beam_launches(launches, flat_calls, beam_calls, n_layer,
                        k3_writes=None):
    """Every flat decoder call launches K4 (direct) and K5 once a layer,
    every grouped beam step K4's beam mode and K5 once a layer. With an
    int8 self-cache, k3_writes = (the decoder calls that wrote it, the
    cross-KV computations): K3 runs once a layer for each."""
    k4, k4b = launches["attend_decode"], launches["attend_decode_beam"]
    k5 = launches["attend_decode_pipelined"]
    log(f"  flat decoder calls {flat_calls}, grouped beam steps "
        f"{beam_calls}: K4 launches {k4} (expected {n_layer * flat_calls}), "
        f"K4 beam-mode launches {k4b} (expected {n_layer} x {beam_calls} = "
        f"{n_layer * beam_calls}), K5 launches {k5} (expected "
        f"{n_layer * (flat_calls + beam_calls)})")
    check(beam_calls > 0 and k4b == n_layer * beam_calls
          and k4 == n_layer * flat_calls
          and k5 == n_layer * (flat_calls + beam_calls),
          "K4's beam mode ran once a layer and grouped beam step, K4 and K5 "
          "as before")
    if "attend_decode_multi" in launches:
        multi = launches["attend_decode_multi"]
        log(f"  K5's multi-query mode: {multi} of the K5 launches (at least "
            f"{n_layer * beam_calls}: every grouped beam step's layers, the "
            f"group's K beams folded; prefills' S > 1 queries too)")
        check(n_layer * beam_calls <= multi <= k5,
              "K5's multi-query mode took every grouped beam step's "
              "cross-attention")
    if k3_writes is not None:
        writes, xkv_calls = k3_writes
        want = n_layer * (writes + xkv_calls)
        log(f"  K3 launches {launches['quantize_heads_kv']} (expected "
            f"{n_layer} x ({writes} decoder calls on the int8 self-cache + "
            f"{xkv_calls} cross-KV computations) = {want})")
        check(launches["quantize_heads_kv"] == want,
              "K3 ran once a layer for each int8 self-cache write and cross-KV")


def phase_beam(eng, longform, beam, whisper, frontend, counters, n_layer):
    """4e: beam search on large-v3 (bf16, int8 cross-KV, the engine's random
    weights, K = 5). The one-shot engine with beam_size=5 on the 20 s
    request, the ladder pinned to its T=0 rung (random weights would send
    the window through the five sampling rungs too); then one window's
    beam decode (32 steps) on the host clock and under a device-only trace;
    then longform.make_server(beam_size=5) with 4 groups on 4 requests of
    5-45 s, and the same server with the int8 self-cache, each with its
    launch counts held, its state_bytes beside what it allocated, and 4
    busy groups timed and traced; last, a 1-group server's tokens on one
    window against the one-shot beam_search_loop on that server's own
    prepared cross-KV (the same shapes, the same kernels: equal). Returns
    {launches name: count} of the bf16 server's run, the one-shot's and
    the int8 server's K4 beam-mode launches."""
    from openhush_tpu_torch.models.whisper import decoding
    from openhush_tpu_torch.runtime import engine as eng_mod
    cfg, params, tok = eng.cfg, eng.params, eng.tokenizer
    out = {}

    # One-shot, one window of speech-like audio.
    audio = speechlike(20.0, SEED + 2)
    ladder = eng_mod.TEMPERATURES
    eng_mod.TEMPERATURES = (0.0,)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        whisper._decode_flat_ro.calls = 0
        whisper.decode_beam_step.calls = 0
        t0 = time.monotonic()
        r = eng.transcribe(audio, beam_size=BEAM,
                           max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        eng_mod.TEMPERATURES = ladder
    launches = {fn.__name__: fn.launches for fn in counters}
    steps = whisper.decode_beam_step.calls
    log(f"  one-shot beam (K={BEAM}): 20 s request, {r.windows} window(s), "
        f"{len(r.segments)} segments, language {r.language}, "
        f"{len(r.text)} chars; {steps} grouped beam steps; {wall:.2f} s "
        f"wall = {20.0 / wall:.2f}x realtime, {wall * 1e3 / steps:.2f} ms "
        f"of wall per beam step (the window's front included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(r.windows == 1 and isinstance(r.text, str), "one-shot beam result")
    for seg in r.segments:
        check(0.0 <= seg.start <= seg.end <= 50.0
              and math.isfinite(seg.avg_logprob), f"segment {seg}")
    check(launches["quantize_heads_kv"] == n_layer
          and launches["flash_attention"] == n_layer,
          "K2 and K3 ran once a layer for the window")
    check_beam_launches(launches, whisper._decode_flat_ro.calls, steps,
                        n_layer)
    out["oneshot"] = launches["attend_decode_beam"]
    out["multi_oneshot"] = launches["attend_decode_multi"]

    # One window's beam decode: host wall and device busy per beam step.
    phase_trace(eng, decoding, whisper, frontend, beam=beam)

    # The beam server: 4 groups, bf16 and int8 self-cache.
    for int8_self in (False, True):
        launches, _ = phase_serving(eng, longform, whisper, counters,
                                    n_layer, int8_self_cache=int8_self,
                                    beam_size=BEAM)
        key = "int8_self" if int8_self else "server"
        out[key] = launches["attend_decode_beam"]
        out["multi_" + key] = launches["attend_decode_multi"]

    # The source-row table's work a step (decode_beam_step's ancestry_rows
    # and the lengths' clamp and cast), at the 4-group server's shape.
    from openhush_tpu_torch.ops.decode_attention import ancestry_rows
    anc = whisper.beam_ancestry(BEAM_GROUPS, BEAM, 128, PROMPT_LEN, "cuda")
    pos = torch.full((BEAM_GROUPS,), 64, device="cuda")
    host, busy = host_and_device(lambda: (ancestry_rows(anc), (pos + 1).clamp(
        max=128).to(torch.int32)), 1000)
    busy = "not measured" if busy is None else f"{busy:.4f} ms"
    log(f"  the source-row table a beam step ({BEAM_GROUPS} groups, 128 "
        f"rows): {host:.4f} ms host wall, {busy} device busy (1000 calls)")

    # One window: a 1-group server against the one-shot beam on the
    # server's own prepared cross-KV.
    srv = longform.make_server(cfg, params, tok, n_files=1, n_slots=1,
                               beam_size=BEAM, max_new_tokens=MAX_NEW_TOKENS,
                               dtype=torch.bfloat16, temperatures=(0.0,),
                               no_speech_threshold=2.0)
    audio = speechlike(10.0, SEED + 65)
    sid = srv.open_session()
    srv.submit_window(sid, audio, language="en")
    got = None
    for _ in range(1000):
        srv.run_once()
        got = srv.poll(sid)
        if got is not None:
            break
    check(got is not None, "the 1-group beam server finished its window")
    window = torch.zeros(1, srv.audio_ctx * 2 * 160, device="cuda")
    window[0, :len(audio)] = torch.from_numpy(audio)
    prompt = tok.sot_sequence("en", "transcribe")
    with torch.inference_mode():
        xkv, _, _ = srv._prep(window, False)
        toks, _, lens, _ = beam.beam_search_loop(
            cfg, params, xkv, torch.tensor([prompt], device="cuda"),
            srv._suppress, beam_size=BEAM, prompt_len=len(prompt),
            max_new=srv.room_cap - len(prompt), use_timestamps=True,
            suppress_blank=True, max_initial_index=50,
            blank_token=srv._blank_token)
    P = len(prompt)
    ref = [int(t) for t in toks[0, P:P + int(lens[0])]
           if t != tok.special.eot]
    log(f"  1-group beam server vs one-shot beam on its cross-KV: "
        f"{len(got.tokens)} tokens, "
        f"{'equal' if got.tokens == ref else 'DIFFERENT'}")
    check(got.tokens == ref, "beam server tokens == one-shot beam tokens")
    return out


def per_call(fn, n: int = 16):
    """Host wall (ms) of one fn() call, n back to back and synchronized,
    then the device busy time (ms) of one call and the top kernels, from a
    device-only trace of n more."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host = (time.monotonic() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy, by_name = device_time(prof)
    return host, busy / 1e3 / n, busy, by_name


def phase_spec(seng, speculative, decoding, whisper, frontend, counters,
               n_layer, EngineServer, batcher):
    """4f: speculative decoding on large-v3 (bf16, int8 cross-KV; the
    engine's random weights) with a large-v3-turbo-shaped draft (4 decoder
    layers, random weights from a generator seeded 1, as the engine makes
    them), and with large-v3 as its own draft. A random draft is the low
    end of acceptance, the self-draft and spec_force_accept the high end.

    1. The one-shot engine with the draft on the 20 s request, the ladder
       pinned to T=0: x-realtime, verify passes, tokens per verify, and
       the launch counts of exactly that run held to the two models' layers
       (K4 = K5 = 32 x big-model flat calls + 4 x draft flat calls; the
       draft's calls = windows + K x verify passes; K2, K3 32 a window).
    2. One 30 s window: host wall and device busy of a draft call (S=1,
       4 layers), a verify call (S=5, 32 layers) and a greedy step (S=1, 32
       layers), the verify's top kernels from a device-only trace.
    3. On that window: greedy, the speculative loop with the draft, and
       with the self-draft (tokens per verify): each speculative run's
       tokens equal greedy's up to the first step whose greedy top-two
       margin (filtered, fp32) is under 4x the max |verify logits - step
       logits| measured on greedy's own tokens (bf16 sums differ between
       M=B*K and M=B GEMMs and S=K and S=1 attention, so a near-tie may
       flip).
    4. A server (1 slot, 128 decode rows, spec_policy "always", k_spec 4)
       with the draft on one window, with and without spec_force_accept,
       and on the int8 self-cache: tokens per iteration, x-realtime,
       state_bytes == its allocation, launch counts held (the draft's
       cross-KV is int8 in the server: 4 more K3 launches a prep batch),
       and the unforced servers' tokens equal a plain server's up to the
       same tie margin (the plain server's margins).
    Returns {"oneshot": K4 launches, "verify": 32 x verify passes,
    "server": K4 launches of the bf16 server, ...}."""
    from openhush_tpu_torch.runtime import engine as eng_mod
    cfg, params, tok = seng.cfg, seng.params, seng.tokenizer
    dcfg, dparams = seng.draft_cfg, seng.draft_params
    check(dcfg is not None and dcfg.n_text_layer == 4,
          "the large-v3-turbo-shaped draft is loaded")
    Ld = dcfg.n_text_layer
    flat = whisper._decode_flat_ro
    loop = speculative.speculative_greedy_loop
    out = {}

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        flat.calls = flat.layers = 0

    # 1. The one-shot engine with the draft.
    audio = speechlike(20.0, SEED + 2)
    eot = tok.special.eot
    ladder, decode_spec, lens = (eng_mod.TEMPERATURES,
                                 speculative.decode_speculative, [])

    def counted(*a, **k):
        res = decode_spec(*a, **k)
        lens.append(emitted(res, min(MAX_NEW_TOKENS, cfg.n_text_ctx
                                     - res.prompt_len - 1), eot))
        return res

    eng_mod.TEMPERATURES = (0.0,)
    speculative.decode_speculative = counted
    try:
        reset()
        loop.verifies = 0
        t0 = time.monotonic()
        r = seng.transcribe(audio, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        eng_mod.TEMPERATURES = ladder
        speculative.decode_speculative = decode_spec
    launches = {fn.__name__: fn.launches for fn in counters}
    verifies = loop.verifies
    per_verify = (sum(lens) - len(lens)) / max(verifies, 1)
    log(f"  one-shot speculative (draft: large-v3-turbo shape, random; "
        f"K={K_ONESHOT}): 20 s request, {r.windows} window(s), "
        f"{len(r.segments)} segments, language {r.language}; {sum(lens)} "
        f"tokens, {verifies} verify passes = {per_verify:.2f} tokens a "
        f"verify; {wall:.2f} s wall = {20.0 / wall:.2f}x realtime; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(r.windows == len(lens) and isinstance(r.text, str) and verifies,
          "one-shot speculative result")
    for seg in r.segments:
        check(0.0 <= seg.start <= seg.end <= 50.0
              and math.isfinite(seg.avg_logprob), f"segment {seg}")
    check(launches["quantize_heads_kv"] == n_layer * r.windows
          and launches["flash_attention"] == n_layer * r.windows,
          "K2 and K3 ran once a layer and window (the draft's one-shot "
          "cross-KV is fp: no K3)")
    big, draft = check_decode_launches(launches, flat.calls, n_layer,
                                       flat_layers=flat.layers,
                                       draft_layers=Ld)
    out["multi_oneshot"] = launches["attend_decode_multi"]
    log(f"  K5's multi-query mode: {out['multi_oneshot']} launches (at "
        f"least {n_layer} x {verifies} verify passes of S={K_ONESHOT})")
    check(n_layer * verifies <= out["multi_oneshot"]
          <= launches["attend_decode_pipelined"],
          "K5's multi-query mode took every verify pass's cross-attention")
    check(draft == len(lens) + K_ONESHOT * verifies,
          f"draft flat calls {draft} == a prefill a window + "
          f"{K_ONESHOT} x {verifies} verify passes")
    out.update(oneshot=launches["attend_decode"],
               verify=n_layer * verifies, draft=Ld * draft)

    # 2. Per-call costs on one window.
    with torch.inference_mode():
        window = torch.from_numpy(speechlike(30.0, SEED + 5)).cuda()[None]
        feats = whisper.encode(cfg, params, frontend.log_mel(
            window, cfg.n_mels).to(seng.dtype))
        xkv, dxkv = seng._cross_kv(feats), seng._draft_cross_kv(feats)
        prompt = torch.tensor([tok.sot_sequence("en")], device="cuda")
        P = prompt.shape[1]
        cache = whisper.init_kv_cache(cfg, 1, seng.dtype, 128, "cuda")
        dcache = whisper.init_kv_cache(dcfg, 1, seng.dtype, 128, "cuda")
        whisper.decode(cfg, params, prompt, 0, cache, xkv)
        whisper.decode(dcfg, dparams, prompt, 0, dcache, dxkv)
        fill = torch.tensor([P + 40], device="cuda")
        tip = prompt[:, -1:]
        block = prompt[:, -1:].repeat(1, K_ONESHOT)
        calls = {
            "draft call (S=1, 4 layers)": lambda: whisper.decode(
                dcfg, dparams, tip, fill, dcache, dxkv),
            f"verify call (S={K_ONESHOT}, 32 layers)": lambda: whisper.decode(
                cfg, params, block, fill, cache, xkv),
            "greedy step (S=1, 32 layers)": lambda: whisper.decode(
                cfg, params, tip, fill, cache, xkv)}
        costs = {}
        for name, fn in calls.items():
            host, dev_ms, busy, by_name = per_call(fn)
            costs[name] = (host, dev_ms)
            log(f"  {name}: {host:.2f} ms host wall, "
                + (f"{dev_ms:.3f} ms device busy" if busy else
                   "device time not measured (no device events)"))
            if name.startswith("verify") and busy:
                for kname, us in sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:6]:
                    log(f"    {us / busy:6.1%}  {us / 1e3 / 16:8.4f} ms a "
                        f"call  {kname[:80]}")
    out["costs"] = costs

    # 3. Greedy, the draft and the self-draft on that window; the tie margin.
    opts = decoding.DecodingOptions(language="en",
                                    max_new_tokens=MAX_NEW_TOKENS)
    suppress = torch.from_numpy(decoding.build_suppress_mask(
        tok, cfg, opts)).cuda()
    steps = []                       # (suppressed logits, top-two margin)
    ts_filter = decoding._timestamp_filter

    def recording(lg, *a, **k):
        res = ts_filter(lg, *a, **k)
        top2 = res[0].topk(2).values
        steps.append((lg[0].clone(), (top2[0] - top2[1]).item()))
        return res

    decoding._timestamp_filter = recording
    try:
        with torch.inference_mode():
            g = decoding.decode_greedy(cfg, params, xkv, tok, opts)
    finally:
        decoding._timestamp_filter = ts_filter
    with torch.inference_mode():
        runs = {}
        for name, dc, dp, dk in (("draft", dcfg, dparams, dxkv),
                                 ("self-draft", cfg, params, xkv)):
            before = loop.verifies
            torch.cuda.synchronize()
            t0 = time.monotonic()
            runs[name] = speculative.decode_speculative(
                cfg, params, dc, dp, xkv, dk, tok, opts, k_spec=K_ONESHOT)
            torch.cuda.synchronize()
            runs[name] = (runs[name], loop.verifies - before,
                          time.monotonic() - t0)
        # |verify - step| logits on greedy's own tokens: its sequence fed in
        # K-blocks at per-row positions, as the verify pass feeds them.
        seq = torch.from_numpy(g.tokens[0]).long().cuda()
        n = len(steps)                   # a filter call a greedy step
        vcache = whisper.init_kv_cache(cfg, 1, seng.dtype,
                                       (P + n + K_ONESHOT + 63) // 64 * 64,
                                       "cuda")
        whisper.decode(cfg, params, seq[None, :P], 0, vcache, xkv)
        diff = 0.0
        keep = ~suppress
        for start in range(P, P + n - 1, K_ONESHOT):
            blk = seq[start:min(start + K_ONESHOT, P + n - 1)]
            vl, _ = whisper.decode(cfg, params, blk[None],
                                   torch.tensor([start], device="cuda"),
                                   vcache, xkv)
            for i in range(blk.shape[0]):
                j = start - P + 1 + i            # the greedy step it predicts
                diff = max(diff, (vl[0, i].float() - steps[j][0]).abs()[
                    keep].max().item())
    thr = 4 * diff
    out["tie_threshold"] = thr
    first_tie = next((j for j, (_, m) in enumerate(steps) if m < thr),
                     len(steps))
    log(f"  greedy on one 30 s window: {n} tokens; verify vs step logits on "
        f"its tokens: max_abs_err {diff:.4f}; first step with a top-two "
        f"margin under 4x that ({thr:.4f}): "
        f"{first_tie if first_tie < len(steps) else 'none'}")
    for name, (res, nv, secs) in runs.items():
        row, ref = res.tokens[0, P:], g.tokens[0, P:]
        first = next((j for j in range(len(ref)) if row[j] != ref[j]),
                     len(ref))
        m = emitted(res, MAX_NEW_TOKENS, eot)
        log(f"  one-shot speculative, {name}: {m} tokens, {nv} verify passes"
            f" = {(m - 1) / max(nv, 1):.2f} tokens a verify, {secs:.2f} s "
            f"wall ({secs * 1e3 / max(m, 1):.1f} ms a token); tokens "
            + ("equal greedy's" if first == len(ref) else
               f"part from greedy's at step {first}"))
        check(first == len(ref) or first >= first_tie,
              f"speculative ({name}) tokens == greedy's up to the first "
              f"near-tie")
        out[name + "_per_verify"] = (m - 1) / max(nv, 1)

    # 4. Servers on one window.
    audio = speechlike(30.0, SEED + 66)
    kw = dict(n_slots=1, inner_steps=8, dtype=torch.bfloat16, tokenizer=tok,
              max_decode_len=128, temperatures=(0.0,), k_spec=K_SPEC)
    margins, choose = [], batcher._choose_tokens

    def recording_choose(lg, st, rows=None):
        top2 = lg.topk(2, dim=-1).values
        margins.append((top2[0, 0] - top2[0, 1]).item())
        return choose(lg, st, rows)

    batcher._choose_tokens = recording_choose
    try:
        [plain] = serve_windows(EngineServer(cfg, params, **kw), [audio])
    finally:
        batcher._choose_tokens = choose
    first_tie = next((j for j, m in enumerate(margins) if m < thr),
                     len(margins))
    for int8_self, forced in ((False, False), (False, True), (True, False)):
        srv = EngineServer(cfg, params, draft=(dcfg, dparams),
                           spec_policy="always", int8_self_cache=int8_self,
                           spec_force_accept=forced, **kw)
        st = srv.state
        allocated = sum(t.numel() * t.element_size()
                        for t in vars(st).values() if torch.is_tensor(t))
        sb = batcher.state_bytes(cfg, 1, dtype=torch.bfloat16, max_len=128,
                                 int8_self_cache=int8_self, draft_cfg=dcfg)
        check(sb == allocated and st.tokens.shape[1] == 128 + 16,
              "spec server state_bytes == its allocation")
        reset()
        t0 = time.monotonic()
        [got] = serve_windows(srv, [audio])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        what = ("int8 self-cache" if int8_self else "bf16") + (
            ", spec_force_accept" if forced else "")
        iters = srv.spec_iters
        first = next((j for j in range(min(len(got), len(plain)))
                      if got[j] != plain[j]), min(len(got), len(plain)))
        same = got == plain
        log(f"  spec server ({what}): {len(got)} tokens in {iters} "
            f"iterations = {(len(got) + 1) / iters:.2f} a verify; 30 s in "
            f"{wall:.2f} s = {30.0 / wall:.2f}x realtime; state "
            f"{sb / 2**20:.2f} MiB (allocated {allocated / 2**20:.2f}); "
            f"tokens vs the plain server's: "
            + ("equal" if same else f"part at step {first}")
            + f"; launches {launches}")
        if not forced:
            check(same or first >= first_tie, f"spec server ({what}) tokens "
                  f"== plain server's up to the first near-tie")
        # The big model's flat calls (a prefill, a verify an iteration)
        # write the int8 self-cache; the draft's cache stays bf16.
        big, draft = check_decode_launches(
            launches, flat.calls, n_layer, flat_layers=flat.layers,
            draft_layers=Ld,
            int8_self=(1 + iters, 1, 1) if int8_self else None)
        check(draft == 1 + K_SPEC * iters and big == 1 + iters,
              f"a prefill of each model, then {K_SPEC} draft calls and one "
              f"verify a spec_step iteration")
        if not int8_self:
            check(launches["quantize_heads_kv"] == n_layer + Ld,
                  "K3 ran once a layer for the big and the draft cross-KV")
        check(n_layer * iters <= launches["attend_decode_multi"],
              f"spec server ({what}): K5's multi-query mode took every "
              f"verify's cross-attention")
        if not int8_self and not forced:
            out.update(server=launches["attend_decode"],
                       server_verify=n_layer * iters,
                       server_pipelined=launches["attend_decode_pipelined"],
                       multi_server=launches["attend_decode_multi"])
        out["server_" + what] = (len(got) + 1) / iters
    return out


def phase_int8_encoder(eng, eng8, whisper, frontend):
    """One window's encoder on the card, W8A8 (eng8's weights) against
    bf16 (eng's, the same values before quantizing), at B=1 and B=8: device
    busy time (and W8A8's top kernels at B=1); then torch._int_mm at the
    MLP's first product ([1500, 1280] x [1280, 5120]) on the column-major
    levels the encoder stores and on a row-major copy, beside the bf16
    product."""
    from torch.profiler import ProfilerActivity, profile
    cfg = eng.cfg

    def device_ms(params, m):
        """Device busy time of one encode (after one warm-up), by a
        device-only trace: an eager W8A8 encode at B=1 queues kernels
        slower than the card runs them, so events would time the host."""
        whisper.encode(cfg, params, m)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            whisper.encode(cfg, params, m)
            torch.cuda.synchronize()
        busy, by_name = device_time(prof)
        return busy / 1e3, by_name

    with torch.inference_mode():
        window = torch.from_numpy(speechlike(30.0, SEED + 5)).cuda()[None]
        mel1 = frontend.log_mel(window, cfg.n_mels).to(eng.dtype)
        for B in (1, SERVE_SLOTS):
            m = mel1.expand(B, -1, -1).contiguous()
            (bf16, _), (w8a8, by_name) = (device_ms(e.params, m)
                                          for e in (eng, eng8))
            log(f"  encoder, one 30 s window x B={B}: device busy W8A8 "
                f"{w8a8:.3f} ms, bf16 {bf16:.3f} ms")
            if B == 1 and w8a8 > 0:
                for name, us in sorted(by_name.items(),
                                       key=lambda kv: -kv[1])[:8]:
                    log(f"    {us / 1e3 / w8a8:6.1%}  {us / 1e3:8.3f} ms  "
                        f"{name[:90]}")
        w = whisper._layers(eng8.params["encoder"]["layers"])[0]["fc1_w"]
        x8 = torch.randint(-127, 128, (1500, w["q"].shape[0]), device="cuda",
                           dtype=torch.int8)
        row_major = w["q"].contiguous()
        check(torch.equal(torch._int_mm(x8, w["q"]),
                          torch._int_mm(x8, row_major)), "_int_mm layouts")
        xb, wb = x8.to(torch.bfloat16), row_major.to(torch.bfloat16)
        log(f"  _int_mm [1500, {w['q'].shape[0]}] x {list(w['q'].shape)}: "
            f"column-major levels "
            f"{time_ms(lambda: torch._int_mm(x8, w['q'])):.4f} ms, row-major "
            f"{time_ms(lambda: torch._int_mm(x8, row_major)):.4f} ms; the "
            f"bf16 product of the same shape {time_ms(lambda: xb @ wb):.4f} "
            f"ms")


def phase_trace(eng, decoding, whisper, frontend, steps=32, beam=None):
    """Where one window's time goes: its greedy decode (t=0, `steps` tokens;
    with the `beam` module, its beam decode at K = BEAM), after a warm-up,
    timed on the host clock, then again under torch.profiler tracing only
    the device (CUDA kernels and copies), so that the trace adds little
    host time. Prints host wall per decoder call (grouped beam step),
    device busy time, idle share and the top kernels. Returns {"host_ms",
    "device_ms"} a call (device_ms None where the trace saw no device
    events)."""
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
                                        suppress_blank=False,
                                        beam_size=BEAM if beam else None)
        run = lambda: (beam.decode_beam if beam else decoding.decode_greedy)(
            cfg, eng.params, xkv, eng.tokenizer, opts)
        run()
        whisper.decode_beam_step.calls = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        untraced = time.monotonic() - t0
        beam_steps = whisper.decode_beam_step.calls
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            res = run()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    # Decoder calls: the prefill, then one per sampled token but the last;
    # beam: the grouped beam steps.
    n = beam_steps or min(steps, int((res.tokens[0, res.prompt_len:]
                                      != eng.tokenizer.special.eot).sum()) + 1)
    busy, by_name = device_time(prof)
    log(f"  window front (log-mel + encoder + int8 cross-KV): "
        f"{front_s * 1e3:.1f} ms host wall")
    out = {"host_ms": untraced * 1e3 / n, "device_ms": None}
    if busy == 0:
        log("  decode trace: the profiler saw no device events; device "
            "time not measured")
        return out
    log(f"  {'beam decode' if beam else 'decode'}: {n} "
        f"{'grouped beam steps' if beam else 'decoder calls'} in "
        f"{untraced * 1e3:.1f} ms host wall "
        f"untraced = {untraced * 1e3 / n:.2f} ms/call; traced "
        f"{wall * 1e3:.1f} ms; device busy {busy / 1e3:.1f} ms "
        f"= {busy / 1e3 / n:.2f} ms/call; device idle share "
        f"{1 - busy / 1e6 / wall:.3f}; {len(by_name)} kernel names")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8 if beam else 6]
    for name, us in top:
        log(f"    {us / busy:6.1%}  {us / 1e3:8.2f} ms  {name[:90]}")
    out["device_ms"] = busy / 1e3 / n
    return out


# Phase 10, the daemon: push-to-talk cycles over IPC (seconds of speech
# each; three of them, a depth that leaves room for the surfaces' cycles
# and phase 11), the silence around them, and the continuous session over
# gated speech.
DAEMON_PTT_SECS = (3.0, 5.0, 8.0)
# Near silence between the cycles: the drive waits for a cycle's windows
# before the next press, so that each cycle's latency is its own.
DAEMON_GAP_SECS = 1.5
# Then one cycle over the REST API, one over D-Bus (where dbus-daemon is on
# PATH; else its audio plays with no press), and F2's pair: a second press
# DAEMON_F2_PRESS_SECS after the first's release, while its final window
# decodes.
DAEMON_SURFACE_CYCLES = (("http", 4.0), ("dbus", 4.0), ("f2a", 5.0),
                         ("f2b", 3.0))
DAEMON_F2_PRESS_SECS = 0.1
DAEMON_CONT_SECS = 30.0
DAEMON_MODEL = "large-v3"        # run 1, in process, at full width
DAEMON_ENTRY_MODEL = "large-v3"  # run 2, through the entry point
DAEMON_START_ARGS = ("--no-tray",)


def _quiet(secs: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1e-3 * rng.standard_normal(int(16000 * secs))).astype(np.float32)


def _words_decode(self, ids):
    """A word a token: the built-in vocabulary (no vocab files here)
    decodes only byte tokens, which random weights seldom emit, so the
    daemon's text pipeline would see empty texts."""
    return " ".join(f"w{int(t)}" for t in ids)


@contextlib.contextmanager
def _env(**values):
    """os.environ with `values` set (None: unset), restored after."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _process_hooks_kept():
    """sys.excepthook, threading.excepthook and the root logger's handlers
    and level put back after the block: `cli.main` sets them process-wide,
    as a process's entry point does, and this script calls it in process."""
    import logging
    hook, thread_hook = sys.excepthook, threading.excepthook
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield
    finally:
        sys.excepthook, threading.excepthook = hook, thread_hook
        root.handlers[:] = handlers
        root.setLevel(level)


def _wait(cond, timeout: float, what: str, poll: float = 0.01) -> None:
    t_end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < t_end, f"{what} within {timeout:.0f} s")
        time.sleep(poll)


def phase_daemon(daemon_mod, ipc, server_mod, tokenizer_mod, capture, cli,
                 counters, tmp):
    """The dictation daemon on the card. Run 1, in process, at large-v3's
    width: a config file with model = "large-v3" in a temp XDG_CONFIG_HOME,
    a temp XDG_RUNTIME_DIR, OPENHUSH_ALLOW_RANDOM_INIT=1, `[api] enabled`
    on a free port with an API key, and a private D-Bus session bus where
    dbus-daemon is on PATH; `_build_daemon()` (what `start` runs: the
    engine, the preprocess, the server at audio_ctx 512 and its warmup),
    build and warmup timed apart; its source swapped for a real-time
    FileSource; `Daemon.run` on a thread, driven through three push-to-talk
    cycles over IPC, one over the REST API, one over D-Bus, F2's pair (the
    second press DAEMON_F2_PRESS_SECS after the first's release) and one
    continuous session over 30 s of gated speech, under a device-only
    trace; then
    unload_model (memory reserved before and after) and load_model (timed).
    The instrumentation (wrappers on the server instance) is installed
    after the warmup, so it sees only the drive's windows. Printed: each
    window's submit-to-text latency, tokens and steps; the
    stop-to-final p50 and p90; the device busy share. Checked: each
    window's text and tokens equal a plain EngineServer's on the same
    weights, audio_ctx and preprocess (the windows replayed in the prep
    batches the daemon made), the daemon's outputs equal the tracker's
    replay of those texts, preprocess_failures 0, K1-K5 and the limiter
    launched, the REST cycle's replies, status and 401, the D-Bus cycle's
    signals and GetStatus, F2's first final in flight at the second press
    and both cycles' texts out in order with 0 pending, the unload gave
    back at least the weights' bytes. Texts are
    a word a token (_words_decode), on the daemon and the plain server
    alike. Run 2, through the entry point: `python -m openhush_tpu_torch.cli
    start --no-tray` with model = "large-v3" (random weights, no warmup),
    driven by the CLI's `status`, `recording start`, `recording stop` (its
    window transcribed before `stop`) and `stop`. `counters`: K1-K5's
    wrappers and the limiter's; returns their launches in run 1."""
    import socket
    from torch.profiler import ProfilerActivity, profile
    from openhush_tpu_torch.api.server import hash_api_key
    EngineServer = server_mod.EngineServer
    run_dir = os.path.join(tmp, "run")
    cfg_home = os.path.join(tmp, "config")
    os.makedirs(os.path.join(cfg_home, "openhush"))
    os.makedirs(run_dir)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        api_port = sock.getsockname()[1]
    with open(os.path.join(cfg_home, "openhush", "config.toml"), "w") as f:
        f.write(f'[transcription]\nmodel = "{DAEMON_MODEL}"\n\n'
                f'[api]\nenabled = true\nhost = "127.0.0.1"\n'
                f'port = {api_port}\n'
                f'api_key_hash = "{hash_api_key(DAEMON_API_KEY)}"\n')
    bus, bus_address = None, None
    if shutil.which("dbus-daemon"):
        bus = subprocess.Popen(
            ["dbus-daemon", "--session", "--print-address", "--nofork"],
            stdout=subprocess.PIPE, text=True)
        bus_address = bus.stdout.readline().strip()
    else:
        log("  D-Bus drive NOT RUN: no dbus-daemon on PATH (its cycle's "
            "audio plays with no press; not counted as passed)")
    warmups = []
    warmup = EngineServer.warmup

    def timed_warmup(self):
        t0 = time.monotonic()
        warmup(self)
        torch.cuda.synchronize()
        warmups.append(time.monotonic() - t0)

    decode = tokenizer_mod.WhisperTokenizer.decode
    EngineServer.warmup = timed_warmup
    tokenizer_mod.WhisperTokenizer.decode = _words_decode
    try:
        with _env(XDG_CONFIG_HOME=cfg_home, XDG_RUNTIME_DIR=run_dir,
                  OPENHUSH_ALLOW_RANDOM_INIT="1", OPENHUSH_CONFIG=None,
                  OPENHUSH_MODEL_DIR=os.path.join(tmp, "models"),
                  OPENHUSH_DRAFT_MODEL=None,
                  DBUS_SESSION_BUS_ADDRESS=bus_address):
            launches = _daemon_in_process(daemon_mod, ipc, server_mod,
                                          capture, counters, warmups,
                                          run_dir, ProfilerActivity, profile,
                                          api_port, bus_address)
    finally:
        EngineServer.warmup = warmup
        tokenizer_mod.WhisperTokenizer.decode = decode
        if bus is not None:
            bus.terminate()
            bus.wait(timeout=10)
    _daemon_entry_point(cli, tmp)
    return launches


DAEMON_API_KEY = "chip-smoke-key"


def _http(port: int, method: str, path: str, key=None):
    """(status, JSON body) of one REST API request."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method,
                                 data=b"" if method == "POST" else None)
    if key:
        req.add_header("X-API-Key", key)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _daemon_in_process(daemon_mod, ipc, server_mod, capture, counters,
                       warmups, run_dir, ProfilerActivity, profile, api_port,
                       bus_address):
    from openhush_tpu_torch.utils import dbus as dbus_mod
    EngineServer = server_mod.EngineServer
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # earlier phases' cache out of the reading
    mem0 = torch.cuda.memory_reserved()
    t0 = time.monotonic()
    d = daemon_mod._build_daemon()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    srv = d.server
    log(f"  _build_daemon ({DAEMON_MODEL}, random weights, bf16): "
        f"{build_s:.2f} s, "
        f"of which the server's warmup {sum(warmups):.2f} s; audio_ctx "
        f"{srv.audio_ctx}, chunk interval {d.chunk_interval} s, "
        f"{srv.n_slots} slots, memory reserved {mem0 / 2**30:.2f} -> "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    check(srv.audio_ctx == 512 and d.chunk_interval == 5.0
          and d.device.type == "cuda" and srv.preprocess is not None,
          "the daemon's server: audio_ctx 512, 5 s chunks, a preprocess")

    # The timeline: push-to-talk cycles with silence around them, then the
    # continuous session.
    parts, ptt, pos = [_quiet(1.0, SEED + 80)], [], 16000
    cycles = [("ipc", secs) for secs in DAEMON_PTT_SECS]
    cycles += list(DAEMON_SURFACE_CYCLES)
    for i, (kind, secs) in enumerate(cycles):
        speech = speechlike(secs, SEED + 81 + i)
        ptt.append((kind, pos, pos + len(speech)))
        gap = DAEMON_F2_PRESS_SECS if kind == "f2a" else DAEMON_GAP_SECS
        parts += [speech, _quiet(gap, SEED + 100 + i)]
        pos += len(speech) + int(16000 * gap)
    cont = gated_speech(DAEMON_CONT_SECS)
    cont_span = (pos, pos + len(cont))
    parts += [cont, _quiet(2.0, SEED + 99)]
    d.source = capture.FileSource(np.concatenate(parts), realtime=True)

    # Instrumentation on the daemon's server instance.
    submitted, polled, outputs, groups = {}, {}, {}, []
    submit, poll, prepare = srv.submit_window, srv.poll, srv._prepare_many
    step, steps_wall, prep_wall = srv._step_state, [], []

    def on_submit(sid, audio, window_id=0, **kw):
        submitted[window_id] = (time.monotonic(), np.array(audio), kw)
        return submit(sid, audio, window_id=window_id, **kw)

    def on_poll(sid, timeout=None):
        r = poll(sid, timeout)
        if r is not None:
            polled[r.window_id] = (time.monotonic(), r)
        return r

    def on_prepare(jobs):
        groups.append([j.window_id for j in jobs])
        t0 = time.perf_counter()
        prepare(jobs)
        prep_wall.append(time.perf_counter() - t0)

    def on_step(deep=False):
        t0 = time.perf_counter()
        step(deep=deep)
        steps_wall.append((time.perf_counter() - t0, srv.inner_steps
                           * (srv.deep_factor if deep else 1)))

    srv.submit_window, srv.poll, srv._prepare_many, srv._step_state = (
        on_submit, on_poll, on_prepare, on_step)
    process = d._process_and_output

    def on_output(ready):
        wid = d._pack(ready.sequence_id, ready.chunk_id, ready.is_final)
        outputs.setdefault(wid, []).append((time.monotonic(), ready.text))
        return process(ready)

    d._process_and_output = on_output
    emitted = []
    d._handler, d.output = None, emitted.append
    # The tracker's calls, in order: each window the daemon hands it, each
    # take_ready (one a drain) and each reset_dedup, for the replay below.
    tracked = []
    tr_add, tr_take, tr_reset = (d.tracker.add_result, d.tracker.take_ready,
                                 d.tracker.reset_dedup)

    def on_add(res):
        tracked.append(("add", d._pack(res.sequence_id, res.chunk_id,
                                       res.is_final)))
        return tr_add(res)

    def on_take():
        tracked.append(("take", None))
        return tr_take()

    def on_reset():
        tracked.append(("reset", None))
        return tr_reset()

    d.tracker.add_result, d.tracker.take_ready, d.tracker.reset_dedup = (
        on_add, on_take, on_reset)

    fns = counters
    for fn in fns:
        fn.launches = 0
    runner = threading.Thread(target=d.run, kwargs={"enable_tray": False},
                              daemon=True)
    client = ipc.IpcClient(timeout=300.0)
    sock = os.path.join(run_dir, "openhush.sock")
    pid_file = os.path.join(run_dir, "openhush.pid")
    stops = {}
    t_drive = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.start()
        _wait(lambda: os.path.exists(sock), 30, "the daemon's socket")
        check(int(open(pid_file).read()) == os.getpid(),
              "the PID file names this process")
        at = lambda n: _wait(lambda: d.ring.current_position() >= n, 60,
                             f"audio position {n}")
        done = lambda: _wait(
            lambda: (client.send("queue_depth")["queue_depth"] == 0
                     and all(w in polled for w in submitted)), 120,
            "every window transcribed", poll=0.05)
        late, seqs, surfaces = [], {}, {}
        dbus_client = listener = None
        if bus_address:
            _wait(lambda: d._dbus is not None, 30, "the D-Bus service")
            dbus_client = dbus_mod.DbusClient(address=bus_address)
            listener = dbus_mod.DbusClient(address=bus_address)
        for kind, start, end in ptt:
            if kind == "dbus" and dbus_client is None:
                continue             # no bus: its audio plays unpressed
            if kind != "f2b":
                done()
            late.append(max(0, d.ring.current_position() - start) / 16000)
            at(start)
            if kind == "dbus":
                listener.subscribe_recording_changed()
                check(dbus_client.call("StartRecording") is True,
                      "D-Bus StartRecording")
            elif kind == "http":
                surfaces["http_start"] = _http(
                    api_port, "POST", "/api/v1/recording/start",
                    DAEMON_API_KEY)
                check(surfaces["http_start"] == (200, {
                    "ok": True, "message": "Recording started"}),
                    f"REST start: {surfaces['http_start']}")
            else:
                check(client.send("start_recording") == {"ok": True},
                      "IPC start_recording")
            if kind == "f2b":
                surfaces["f2_in_flight"] = [sid for _, sid in d._draining]
            seq = d._sequence
            seqs[kind] = seq
            at(end)
            stops[seq] = time.monotonic()
            if kind == "dbus":
                check(dbus_client.call("StopRecording") is True,
                      "D-Bus StopRecording")
                surfaces["dbus_signals"] = [
                    listener.wait_recording_changed(30) for _ in range(2)]
                surfaces["dbus_status"] = json.loads(
                    dbus_client.call("GetStatus"))
            elif kind == "http":
                surfaces["http_stop"] = _http(
                    api_port, "POST", "/api/v1/recording/stop",
                    DAEMON_API_KEY)
                check(surfaces["http_stop"] == (200, {
                    "ok": True, "message": "Recording stopped"}),
                    f"REST stop: {surfaces['http_stop']}")
            else:
                check(client.send("stop_recording") == {"ok": True},
                      "IPC stop_recording")
            if kind == "http":
                done()
                surfaces["http_status"] = _http(
                    api_port, "GET", "/api/v1/status", DAEMON_API_KEY)
                surfaces["http_401"] = _http(api_port, "GET",
                                             "/api/v1/status")
                surfaces["http_health"] = _http(api_port, "GET",
                                                "/api/v1/health")
        done()
        surfaces["f2_pending"] = d.tracker.pending_count
        for c in (dbus_client, listener):
            if c is not None:
                c.close()
        late.append(max(0, d.ring.current_position() - cont_span[0]) / 16000)
        at(cont_span[0])
        check(client.send("start_continuous") == {"ok": True},
              "IPC start_continuous")
        cont_seq = d._sequence
        at(cont_span[1])
        check(client.send("stop_recording") == {"ok": True},
              "IPC stop_recording (continuous)")
        done()
        time.sleep(0.1)          # the drain that follows the last poll
        torch.cuda.synchronize()
        drive_s = time.monotonic() - t_drive
    parse_s = time.monotonic() - t_drive - drive_s
    t0 = time.monotonic()
    busy_us, _ = device_time(prof)
    trace_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in fns}
    del prof

    windows = sorted(submitted)
    kinds = {}
    for w in windows:
        seq, chunk, final = d._unpack(w)
        kinds[w] = ("vad" if seq == cont_seq else
                    "final" if final else "partial")
    log(f"  drive: {len(DAEMON_PTT_SECS)} push-to-talk cycles of "
        f"{DAEMON_PTT_SECS} s over IPC, then {DAEMON_SURFACE_CYCLES} (REST, "
        f"D-Bus{'' if bus_address else ' not pressed'}, F2's pair over "
        f"IPC) and {DAEMON_CONT_SECS} s of continuous "
        f"dictation in {drive_s:.2f} s wall; {len(windows)} windows "
        f"({sum(k == 'partial' for k in kinds.values())} partial, "
        f"{sum(k == 'final' for k in kinds.values())} final, "
        f"{sum(k == 'vad' for k in kinds.values())} VAD segments); prep "
        f"batches {[len(g) for g in groups]}; presses "
        f"late by {', '.join(f'{x:.2f}' for x in late)} s (the previous "
        f"windows still in flight at the planned press)")
    lat = {}
    for w in windows:
        t_sub, audio, _ = submitted[w]
        t_poll, r = polled[w]
        t_out = outputs[w][0][0] if w in outputs else None
        lat[w] = (t_out if t_out is not None else t_poll) - t_sub
        log(f"    window {kinds[w]:7s} seq {w >> 32} chunk "
            f"{(w & 0xFFFFFFFF) >> 1}: {len(audio) / 16000:5.2f} s of audio, "
            f"submit -> {'text' if t_out is not None else 'result (no text)'}"
            f" {lat[w] * 1e3:8.1f} ms, {len(r.tokens)} tokens, {r.steps} "
            f"steps, {lat[w] * 1e3 / max(r.steps, 1):.1f} ms a step, "
            f"server latency {r.latency * 1e3:.1f} ms, language {r.language}")
    finals = [w for w in windows if kinds[w] == "final"]
    stop_final = [(outputs[w][0][0] if w in outputs else polled[w][0])
                  - stops[w >> 32] for w in finals]
    steps_final = [polled[w][1].steps for w in finals]
    p50, p90 = np.percentile(stop_final, 50), np.percentile(stop_final, 90)
    first = [lat[w] for w in windows if kinds[w] == "partial"]
    log(f"  stop -> final text over {len(finals)} cycles: p50 "
        f"{p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms (median "
        f"{np.median(steps_final):.0f} decode steps; "
        f"{p50 * 1e3 / max(np.median(steps_final), 1):.1f} ms a step at "
        f"p50); first partial submit -> text "
        f"{', '.join(f'{x * 1e3:.1f}' for x in first)} ms")
    log(f"  device busy {busy_us / 1e3:.1f} ms of {drive_s * 1e3:.1f} ms "
        f"wall: busy share {busy_us / 1e6 / drive_s:.4f} (the profiler took "
        f"{parse_s:.1f} s to close, the trace {trace_s:.1f} s to read)")
    n_inner = sum(n for _, n in steps_wall)
    log(f"  the server inside the daemon: {len(steps_wall)} step dispatches "
        f"({n_inner} decode steps over 8 slots), "
        f"{sum(w for w, _ in steps_wall) * 1e3 / max(n_inner, 1):.1f} ms of "
        f"host wall a decode step; {len(prep_wall)} prep batches "
        f"(preprocess, mel, encoder, cross-KV, language), "
        f"{np.median(prep_wall) * 1e3:.1f} ms each (median)")
    log(f"  launches over the drive: {launches}; preprocess_failures "
        f"{srv.preprocess_failures}; outputs {len(emitted)}")
    check(busy_us > 0, "the trace saw device work")
    check(srv.preprocess_failures == 0
          and client.send("status")["preprocess_failures"] == 0,
          "preprocess_failures == 0 (phase 10), on the server and in the "
          "IPC status reply")
    check(all(n > 0 for n in launches.values()),
          "K1-K5 and the limiter launched during the phase")
    pressed = len(DAEMON_PTT_SECS) + len(DAEMON_SURFACE_CYCLES) - (
        0 if bus_address else 1)
    check(len(finals) == pressed
          and sum(k == "vad" for k in kinds.values()) >= 2,
          "a final window a cycle and VAD segments in the continuous run")

    # The surfaces: the REST API cycle, the D-Bus cycle, F2's pair.
    def final_of(seq):
        return next(w for w in finals if w >> 32 == seq)

    def out_at(w):
        return outputs[w][0][0] if w in outputs else None

    http_final = final_of(seqs["http"])
    check(out_at(http_final) is not None
          and out_at(http_final) > stops[seqs["http"]],
          "the REST cycle's text was output after its stop")
    http_s = out_at(http_final) - stops[seqs["http"]]
    st_code, st = surfaces["http_status"]
    log(f"  REST API cycle (POST start/stop on 127.0.0.1:{api_port}): stop "
        f"-> text {http_s * 1e3:.1f} ms ({polled[http_final][1].steps} "
        f"decode steps); status {st_code} {st}; without the key "
        f"{surfaces['http_401']}; health {surfaces['http_health'][0]}")
    check(st_code == 200 and st["queue_depth"] == 0
          and st["preprocess_failures"] == 0 and not st["recording"]
          and st["model"] == DAEMON_MODEL,
          "REST status: queue_depth 0, preprocess_failures 0")
    check(surfaces["http_401"][0] == 401
          and "Missing X-API-Key" in surfaces["http_401"][1]["error"]
          and surfaces["http_health"][0] == 200,
          "REST: 401 without the key, health public")
    if bus_address:
        dst = surfaces["dbus_status"]
        dbus_final = final_of(seqs["dbus"])
        log(f"  D-Bus cycle (private session bus): StartRecording, "
            f"StopRecording, IsRecordingChanged {surfaces['dbus_signals']}, "
            f"GetStatus {dst}; stop -> text "
            f"{(out_at(dbus_final) - stops[seqs['dbus']]) * 1e3:.1f} ms")
        check(surfaces["dbus_signals"] == [True, False],
              "two IsRecordingChanged signals: True, then False")
        check(not dst["recording"] and dst["state"] == "idle"
              and dst["preprocess_failures"] == 0,
              "D-Bus GetStatus after StopRecording")
        check(out_at(dbus_final) is not None,
              "the D-Bus cycle's text was output")
    f2a, f2b = final_of(seqs["f2a"]), [w for w in windows
                                       if w >> 32 == seqs["f2b"]]
    f2_times = [out_at(f2a)] + [out_at(w) for w in f2b]
    log(f"  F2: the second press {DAEMON_F2_PRESS_SECS} s after the "
        f"release, with session(s) {surfaces['f2_in_flight']} still in "
        f"flight; the first's final out "
        f"{(f2_times[0] - stops[seqs['f2a']]) * 1e3:.1f} ms after its "
        f"release, the second's windows after it: "
        f"{[None if t is None else round((t - f2_times[0]) * 1e3, 1) for t in f2_times[1:]]} "
        f"ms; pending after {surfaces['f2_pending']}")
    check(surfaces["f2_in_flight"] != [],
          "F2: the first cycle's final window was in flight at the press")
    f2_texts = [polled[w][1].text.strip() for w in [f2a] + f2b]
    check(f2_texts[0] != "" and all((t is not None) == (x != "") for t, x
                                    in zip(f2_times, f2_texts))
          and all(t >= f2_times[0] for t in f2_times[1:] if t is not None)
          and surfaces["f2_pending"] == 0,
          "F2: both cycles' texts out, in order, 0 pending")

    # The daemon's outputs are the tracker's replay of its window texts: the
    # windows' texts as the server returned them, fed drain by drain (the
    # windows each take_ready took), reset where the daemon reset it.
    from openhush_tpu_torch.runtime.tracker import (ChunkResult,
                                                    TranscriptionTracker)
    tracker = TranscriptionTracker(streaming=True)
    replay, drains, drain = [], [], []
    for what, w in tracked:
        if what == "reset":
            tracker.reset_dedup()
            drains.append("reset")
        elif what == "add":
            seq, chunk, final = d._unpack(w)
            tracker.add_result(ChunkResult(
                text=polled[w][1].text.strip(), sequence_id=seq,
                chunk_id=chunk, is_final=final, duration_secs=0.0))
            drain.append((seq, chunk))
        else:
            replay += [r.text for r in tracker.take_ready() if r.text]
            if drain:
                drains.append(drain)
            drain = []
    out_of_order = sum(d_ != sorted(d_) for d_ in drains if d_ != "reset")
    log(f"  the tracker: {sum(x != 'reset' for x in drains)} drains that "
        f"took windows ({sum(len(x) > 1 for x in drains if x != 'reset')} "
        f"took several, {out_of_order} out of chunk order), "
        f"{drains.count('reset')} resets")
    if emitted != replay:
        log(f"  the daemon's outputs {emitted}\n  the tracker's replay, "
            f"drain by drain {replay}\n  the drains (seq, chunk) and resets "
            f"{drains}\n  the windows (seq, chunk, final, poll s, text): "
            f"{[(*d._unpack(w), round(polled[w][0] - t_drive, 3), polled[w][1].text.strip()) for w in sorted(polled, key=lambda w: polled[w][0])]}")
    check(emitted == replay, "the daemon's outputs == the tracker's replay "
          "of its windows' texts")
    del d.tracker.add_result, d.tracker.take_ready, d.tracker.reset_dedup

    # Unload, then load, over IPC.
    weights_bytes = server_mod._nbytes(srv.params)
    checksum = float(srv.params["decoder"]["tok_emb"].float().sum())
    results = {w: (r.tokens, r.text) for w, (_, r) in polled.items()}
    # Drop every reference to the server (the class's methods back on the
    # instance first: the daemon's loop still polls it) so that the unload
    # can free it.
    del srv.submit_window, srv.poll, srv._prepare_many, srv._step_state
    del srv, submit, poll, prepare, step, on_submit, on_poll, on_prepare
    del on_step, polled
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    before_a = torch.cuda.memory_allocated()
    check(client.send("unload_model") == {"ok": True}, "IPC unload_model")
    after = torch.cuda.memory_reserved()
    after_a = torch.cuda.memory_allocated()
    check(not client.send("status")["model_loaded"], "unloaded")
    t0 = time.monotonic()
    check(client.send("load_model") == {"ok": True}, "IPC load_model")
    reload_s = time.monotonic() - t0
    st = client.send("status")
    log(f"  unload: memory reserved {before / 2**30:.3f} -> "
        f"{after / 2**30:.3f} GiB, allocated {before_a / 2**30:.3f} -> "
        f"{after_a / 2**30:.3f} GiB (weights {weights_bytes / 2**30:.3f} "
        f"GiB; reserved at the build's start {mem0 / 2**30:.3f} GiB);"
        f" reload {reload_s:.2f} s (warmup {warmups[-1]:.2f} s of it); "
        f"status {st}")
    check(before - after >= weights_bytes,
          "the unload gave back at least the weights' bytes")
    check(st["model_loaded"] and st["state"] == "idle", "reloaded")
    srv = d.server
    check(float(srv.params["decoder"]["tok_emb"].float().sum()) == checksum,
          "the reload built the same weights (seed 0)")

    # A plain server on the same weights, audio_ctx and preprocess, fed
    # the same windows in the prep batches the daemon made. A batch is
    # submitted once the one before it has been prepared (run_once
    # prepares whatever is pending as one batch), so that the batches
    # decode side by side, as they did in the daemon.
    plain = EngineServer(srv.cfg, srv.params, tokenizer=srv.tokenizer,
                         dtype=torch.bfloat16, audio_ctx=srv.audio_ctx,
                         max_decode_len=256, preprocess=srv.preprocess,
                         temperatures=(0.0,), logprob_threshold=-1e9,
                         no_speech_threshold=2.0)
    sids, got, waiting, t0 = {}, {}, list(groups), time.monotonic()
    for _ in range(4000):
        if waiting and plain._pending.empty():
            for w in waiting.pop(0):
                sids[w] = plain.open_session()
                _, audio, kw = submitted[w]
                plain.submit_window(sids[w], audio, window_id=w, **kw)
        plain.run_once()
        for w, sid in sids.items():
            r = plain.poll(sid)
            if r is not None:
                got[w] = (r.tokens, r.text)
        if not waiting and len(got) == len(results):
            break
    same = 0
    for w in windows:
        ok = got.get(w) == results[w]
        same += ok
        if not ok:
            log(f"    window {w:#x}: daemon {results[w][0][:24]} vs "
                f"plain {got.get(w, ([], ''))[0][:24]}")
    log(f"  plain server on the same windows: {same} of {len(results)} "
        f"windows with equal tokens and text ({time.monotonic() - t0:.1f} s)")
    check(same == len(results), "the daemon's window texts == a plain "
          "server's on the same windows")
    del plain, srv
    check(client.send("stop") == {"ok": True}, "IPC stop")
    runner.join(timeout=60)
    check(not runner.is_alive() and not os.path.exists(pid_file),
          "the daemon stopped and removed its PID file")
    return launches


def _daemon_entry_point(cli, tmp):
    """`python -m openhush_tpu_torch.cli start --no-tray` (model large-v3,
    random weights, warmup_on_load off) in a subprocess, driven by the
    CLI's status, recording start, recording stop and stop; between the
    last two, status until the queue is empty: the recording's window was
    transcribed at full width."""
    import io
    run_dir = os.path.join(tmp, "run2")
    os.makedirs(run_dir)
    cfg = os.path.join(tmp, "entry.toml")
    with open(cfg, "w") as f:
        f.write(f'[transcription]\nmodel = "{DAEMON_ENTRY_MODEL}"\n'
                'warmup_on_load = false\n')
    pid_file = os.path.join(run_dir, "openhush.pid")
    env = dict(os.environ, PYTHONPATH=ROOT, OPENHUSH_CONFIG=cfg,
               OPENHUSH_ALLOW_RANDOM_INIT="1", XDG_RUNTIME_DIR=run_dir,
               OPENHUSH_MODEL_DIR=os.path.join(tmp, "models"))
    env.pop("OPENHUSH_DRAFT_MODEL", None)

    def cmd(*args):
        out = io.StringIO()
        with _env(XDG_RUNTIME_DIR=run_dir, OPENHUSH_CONFIG=cfg), \
                _process_hooks_kept(), contextlib.redirect_stdout(out):
            rc = cli.main(list(args))
        return rc, out.getvalue()

    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "openhush_tpu_torch.cli", "start",
         *DAEMON_START_ARGS], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _wait(lambda: (os.path.exists(os.path.join(run_dir, "openhush.sock"))
                       or proc.poll() is not None), 300,
              "the daemon's socket", poll=0.1)
        check(proc.poll() is None, "the daemon is running")
        up_s = time.monotonic() - t0
        check(int(open(pid_file).read()) == proc.pid,
              "the PID file names the daemon")
        seen = [("status",) + cmd("status")]
        seen.append(("recording start",) + cmd("recording", "start"))
        seen.append(("status",) + cmd("status"))
        time.sleep(1.0)
        seen.append(("recording stop",) + cmd("recording", "stop"))
        seen.append(("status",) + cmd("status"))
        t_stop = time.monotonic()
        _wait(lambda: "Queue depth: 0" in cmd("status")[1], 120,
              "the recording's window transcribed", poll=0.1)
        drain_s = time.monotonic() - t_stop
        seen.append(("status",) + cmd("status"))
        seen.append(("stop",) + cmd("stop"))
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
        _, err = proc.communicate()
    for what, code, out in seen:
        log(f"  entry point: `{what}` -> rc {code}: "
            f"{out.strip().replace(chr(10), '; ')}")
    check([c for _, c, _ in seen] == [0] * 7, "every CLI command exits 0")
    states = [o for w, _, o in seen if w == "status"]
    check("State: idle" in states[0] and "State: recording" in states[1]
          and "State: idle" in states[2] and "Queue depth: 1" in states[2]
          and "Queue depth: 0" in states[3]
          and "Preprocess failures: 0" in states[3],
          "status prints idle, recording, idle with the recording's window "
          "queued, then an empty queue and no preprocess failure")
    check(rc == 0, f"the daemon exits 0 (rc {rc}): {err[-2000:]}")
    check(not os.path.exists(pid_file), "the PID file is removed")
    log(f"  entry point ({DAEMON_ENTRY_MODEL}): up in {up_s:.1f} s, the "
        f"recording's window out {drain_s:.1f} s after `recording stop`, "
        f"exit 0, PID file removed")


# Phase 11, `record` on the card: phase 8's 45 s of two synthetic speakers
# (5 s chunks, 0.5 s overlap: windows at 0, 4.5, ..., 40.5 s), large-v3.
RECORD_SECS = 45.0
RECORD_MODEL = "large-v3"
RECORD_DEADLINE_S = 300
RECORD_WINDOWS = tuple(4500 * k for k in range(10))


def word_vocab(path: str, eot: int) -> None:
    """A vocab.json in GPT-2's byte-level layout whose ids 0-255 are the 256
    bytes and every later id below EOT the word " w<id>": with it in the
    model directory, the CLI's tokenizer (WhisperTokenizer.for_model)
    decodes every token random weights emit, where the built-in byte
    vocabulary decodes few (chip_smoke has no real vocabulary files)."""
    from openhush_tpu_torch.text.tokenizer import _bytes_to_unicode
    enc = _bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    vocab.update({f"{enc[32]}w{i}": i for i in range(256, eot)})
    with open(path, "w") as f:
        json.dump(vocab, f)


def parse_srt(text: str) -> list:
    """SRT cues → [(index, start ms, end ms, speaker or None, text)]."""
    def ms(stamp):
        hms, milli = stamp.split(",")
        h, m, sec = map(int, hms.split(":"))
        return ((h * 60 + m) * 60 + sec) * 1000 + int(milli)

    cues = []
    for block in text.strip().split("\n\n"):
        if not block.strip():
            continue
        index, times, body = block.strip().split("\n", 2)
        start, end = times.split(" --> ")
        speaker = None
        if body.startswith("<v Speaker "):
            head, body = body.split(">", 1)
            speaker = int(head[len("<v Speaker "):])
        cues.append((int(index), ms(start), ms(end), speaker, body))
    return cues


def phase_record(recording, diarization, sp, counters, tmp):
    """`python -m openhush_tpu_torch.cli record --source file:<wav> --format
    srt --diarize --model large-v3 -o <srt>` in a subprocess on phase 8's
    45 s of two synthetic speakers (random weights, OPENHUSH_LOG=debug, a
    word vocabulary in the model directory, no --max-duration): it must
    exit 0 by itself (F3) within RECORD_DEADLINE_S, its engine on CUDA;
    the SRT (file and live stdout) parses, its cues in order, one for each
    of the 10 windows, each window's text equal to a plain in-process
    EngineServer's (recording.build_server: the same random weights, the
    chunk cut replayed in the prep batches the subprocess logged) and each
    speaker to the dominant speaker of a fresh in-process
    DiarizationEngine's diarize_chunk on that chunk. Printed: the wall,
    audio seconds per wall second, each window's submit-to-result latency
    and the diarizer's host time a chunk (from the subprocess's log), and,
    from an in-process repeat of the session under a device-only trace,
    the busy share and the diarizer's share of the loop. `counters`: K1-K5;
    returns their launches in the repeat."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from openhush_tpu_torch.audio.capture import FileSource
    from openhush_tpu_torch.audio.wav import save_wav
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
    models = os.path.join(tmp, "record_models")
    os.makedirs(models)
    n_langs = 100
    word_vocab(os.path.join(models, "vocab.json"),
               WhisperTokenizer(n_langs).special.eot)
    cfg_path = os.path.join(tmp, "record.toml")
    with open(cfg_path, "w") as f:
        f.write('[transcription]\nlanguage = "auto"\n')
    audio = conversation(sp, RECORD_SECS, SEED + 85)
    wav, out = os.path.join(tmp, "meeting.wav"), os.path.join(tmp, "m.srt")
    save_wav(wav, audio)
    env = dict(os.environ, PYTHONPATH=ROOT, OPENHUSH_ALLOW_RANDOM_INIT="1",
               OPENHUSH_MODEL_DIR=models, OPENHUSH_CONFIG=cfg_path,
               OPENHUSH_LOG="debug")
    env.pop("OPENHUSH_DRAFT_MODEL", None)
    t0 = time.monotonic()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "openhush_tpu_torch.cli", "record",
             "--source", f"file:{wav}", "--format", "srt", "--diarize",
             "--model", RECORD_MODEL, "-o", out], capture_output=True,
            text=True, env=env, cwd=ROOT, timeout=RECORD_DEADLINE_S)
    except subprocess.TimeoutExpired:
        check(False, f"record ended by itself within {RECORD_DEADLINE_S} s")
    wall = time.monotonic() - t0
    check(r.returncode == 0,
          f"record exit {r.returncode}: {r.stderr[-3000:]}")
    check(f"record: {RECORD_MODEL} on cuda" in r.stderr,
          "record built its engine on CUDA")
    batches = [json.loads(m) for m in re.findall(
        r"prep batch: windows (\[[0-9, ]*\])", r.stderr)]
    lat = {int(w): float(v) for w, v in re.findall(
        r"window at (\d+) ms: submit -> result ([0-9.]+) ms", r.stderr)}
    dz_ms = [float(v) for v in re.findall(
        r"diarized the chunk at \d+ ms in ([0-9.]+) ms", r.stderr)]
    cues = parse_srt(open(out).read())
    live = parse_srt(r.stdout)
    log(f"  record (subprocess, {RECORD_MODEL}, random weights, "
        f"--diarize, {RECORD_SECS:.0f} s of audio): exit 0 by itself in "
        f"{wall:.2f} s wall, {RECORD_SECS / wall:.3f} audio s a wall s "
        f"(python, torch, the engine's and the diarizer's build included); "
        f"{len(cues)} cues; prep batches {[len(b) for b in batches]}")
    log(f"    submit -> result a window: "
        f"{', '.join(f'{w / 1000:g} s {lat[w]:.1f} ms' for w in sorted(lat))}")
    log(f"    the diarizer a 5 s chunk (host, on the capture loop): median "
        f"{np.median(dz_ms):.2f} ms, max {max(dz_ms):.2f} ms over "
        f"{len(dz_ms)} chunks")
    check(sorted(lat) == list(RECORD_WINDOWS)
          and len(dz_ms) == len(RECORD_WINDOWS)
          and sorted(w for b in batches for w in b) == list(RECORD_WINDOWS),
          "record: every window submitted, prepared and drained")
    check([c[0] for c in cues] == list(range(1, len(cues) + 1))
          and [c[1] for c in cues] == sorted(c[1] for c in cues)
          and all(c[2] == c[1] + 5000 for c in cues),
          "the SRT parses, its cues in order")
    check(sorted(c[1:] for c in live) == sorted(c[1:] for c in cues),
          "the live SRT on stdout == the file's cues")

    # A plain server on the same weights, the chunk cut replayed in the
    # subprocess's prep batches; a fresh diarizer on the same chunks.
    chunks = {w: audio[16 * w:16 * w + 80000] for w in RECORD_WINDOWS}
    with _env(OPENHUSH_ALLOW_RANDOM_INIT="1", OPENHUSH_MODEL_DIR=models,
              OPENHUSH_DRAFT_MODEL=None):
        eng, plain = recording.build_server(RECORD_MODEL)
        diarizer = diarization.DiarizationEngine.from_local()
    check(eng.random_init and eng.draft_cfg is None
          and plain.audio_ctx == get_config(RECORD_MODEL).n_audio_ctx
          and plain.preprocess is None, "build_server: no draft, full "
          "audio_ctx, no preprocess")
    t0 = time.monotonic()
    sid, got, waiting = plain.open_session(), {}, list(batches)
    for _ in range(20000):
        if waiting and plain._pending.empty():
            for w in waiting.pop(0):
                plain.submit_window(sid, chunks[w], window_id=w,
                                    timestamps=False)
        plain.run_once()
        while (res := plain.poll(sid)) is not None:
            got[res.window_id] = res.text.strip()
        if not waiting and len(got) == len(RECORD_WINDOWS):
            break
    replay_s = time.monotonic() - t0
    speakers = {w: recording.dominant_speaker(
        diarizer.diarize_chunk(chunks[w], offset_secs=w / 1000))
        for w in RECORD_WINDOWS}
    by_start = {c[1]: c for c in cues}
    same_text = sum(by_start.get(w, (0, 0, 0, None, ""))[4] == got.get(w)
                    for w in RECORD_WINDOWS)
    same_spk = sum(w in by_start and by_start[w][3] == speakers[w]
                   for w in RECORD_WINDOWS)
    log(f"  in process: {same_text} of {len(RECORD_WINDOWS)} windows' "
        f"texts equal a plain server's ({replay_s:.1f} s), {same_spk} "
        f"speakers equal the diarizer's dominant speaker; speakers "
        f"{[speakers[w] for w in RECORD_WINDOWS]}, texts "
        f"{[len(got.get(w, '').split()) for w in RECORD_WINDOWS]} words")
    for w in RECORD_WINDOWS:
        if w in by_start and by_start[w][4] != got.get(w):
            a, b = by_start[w][4].split(), got.get(w, "").split()
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            log(f"    window {w} ms: record and plain part at word {i} "
                f"of {len(a)} and {len(b)}: {a[i:i + 4]} vs {b[i:i + 4]}")
    check(len(cues) == len(RECORD_WINDOWS)
          and all(got.get(w) for w in RECORD_WINDOWS),
          "one cue for each of the 10 windows, each with text")
    check(same_text == len(RECORD_WINDOWS),
          "record's window texts == a plain server's on the same cut")
    check(same_spk == len(RECORD_WINDOWS),
          "record's speakers == the in-process diarizer's")

    # An in-process repeat of the session, traced.
    for fn in counters:
        fn.launches = 0
    diarizer.reset()
    session = recording.RecordingSession(
        recording.RecordingConfig(source="file", output_format="srt",
                                  enable_diarization=True, live_mode=False),
        plain, FileSource(audio, realtime=False), diarizer=diarizer)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        session.run()
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
    busy_us, _ = device_time(prof)
    launches = {fn.__name__: fn.launches for fn in counters}
    del prof
    dz_share = sum(session.diarize_secs) / run_s
    log(f"  in-process repeat (traced): {run_s:.2f} s wall, "
        f"{RECORD_SECS / run_s:.3f} audio s a wall s, device busy "
        f"{busy_us / 1e3:.1f} ms: busy share {busy_us / 1e6 / run_s:.4f}; "
        f"the diarizer {sum(session.diarize_secs) * 1e3:.1f} ms of host "
        f"on the loop ({dz_share:.4f} of the wall; median "
        f"{np.median(session.diarize_secs) * 1e3:.2f} ms a chunk); "
        f"submit -> result median "
        f"{np.median(list(session.latencies.values())) * 1e3:.1f} ms; "
        f"launches {launches}")
    check(busy_us > 0 and all(n > 0 for n in launches.values())
          and len(session.latencies) == len(RECORD_WINDOWS),
          "the repeat ran K1-K5 on the card over every window")
    del eng, plain, diarizer, session
    return launches


# Phase 12: `model convert` and `evaluate` at large-v3-turbo's full width.
EVAL_MODEL = "large-v3-turbo"
EVAL_SECS = (5.0, 7.5, 10.0, 12.0)
EVAL_REFS = ("HE HOPED THERE WOULD BE STEW FOR DINNER",
             "TURNIPS AND CARROTS AND BRUISED POTATOES AND FAT MUTTON PIECES",
             "STUFF IT INTO YOU HIS BELLY COUNSELLED HIM",
             "AFTER EARLY NIGHTFALL THE YELLOW LAMPS WOULD LIGHT UP HERE AND "
             "THERE")
# The hand kernels' names in a torch.profiler trace (K1-K5).
TRACE_KERNELS = {"K1": "log_mel_kernel", "K2": "flash_attention_tc_kernel",
                 "K3": "quantize_heads_kernel",
                 "K4": "decode_attention_kernel",
                 "K5": "decode_attention_split_kernel"}
# (our leaf, HF name, transposed) of one encoder and one decoder layer.
_HF_ATTN = (("ln1_scale", "self_attn_layer_norm.weight", False),
            ("ln1_bias", "self_attn_layer_norm.bias", False),
            ("q_w", "self_attn.q_proj.weight", True),
            ("q_b", "self_attn.q_proj.bias", False),
            ("k_w", "self_attn.k_proj.weight", True),
            ("v_w", "self_attn.v_proj.weight", True),
            ("v_b", "self_attn.v_proj.bias", False),
            ("o_w", "self_attn.out_proj.weight", True),
            ("o_b", "self_attn.out_proj.bias", False))
_HF_MLP = (("fc1_w", "fc1.weight", True), ("fc1_b", "fc1.bias", False),
           ("fc2_w", "fc2.weight", True), ("fc2_b", "fc2.bias", False))
_HF_ENC = _HF_ATTN + (("ln2_scale", "final_layer_norm.weight", False),
                      ("ln2_bias", "final_layer_norm.bias", False)) + _HF_MLP
_HF_DEC = _HF_ATTN + (
    ("ln2_scale", "encoder_attn_layer_norm.weight", False),
    ("ln2_bias", "encoder_attn_layer_norm.bias", False),
    ("xq_w", "encoder_attn.q_proj.weight", True),
    ("xq_b", "encoder_attn.q_proj.bias", False),
    ("xk_w", "encoder_attn.k_proj.weight", True),
    ("xv_w", "encoder_attn.v_proj.weight", True),
    ("xv_b", "encoder_attn.v_proj.bias", False),
    ("xo_w", "encoder_attn.out_proj.weight", True),
    ("xo_b", "encoder_attn.out_proj.bias", False),
    ("ln3_scale", "final_layer_norm.weight", False),
    ("ln3_bias", "final_layer_norm.bias", False)) + _HF_MLP


def hf_state_dict(cfg, params) -> dict:
    """The inverse of convert.from_hf_state_dict: our tree → HF
    WhisperForConditionalGeneration names and layouts ([in, out] →
    [out, in], HIO → [out, in, k], the layers unstacked, tok_emb cut back
    to n_vocab), each tensor in fp16 as the hub publishes Whisper."""
    sd = {}

    def put(name, t):
        sd[name] = t.detach().to(torch.float16).contiguous().cpu().numpy()

    enc, dec = params["encoder"], params["decoder"]
    for i in (1, 2):
        put(f"model.encoder.conv{i}.weight", enc[f"conv{i}_w"].permute(2, 1, 0))
        put(f"model.encoder.conv{i}.bias", enc[f"conv{i}_b"])
    put("model.encoder.embed_positions.weight", enc["pos_emb"])
    put("model.encoder.layer_norm.weight", enc["ln_post_scale"])
    put("model.encoder.layer_norm.bias", enc["ln_post_bias"])
    put("model.decoder.embed_tokens.weight", dec["tok_emb"][:cfg.n_vocab])
    put("model.decoder.embed_positions.weight", dec["pos_emb"])
    put("model.decoder.layer_norm.weight", dec["ln_scale"])
    put("model.decoder.layer_norm.bias", dec["ln_bias"])
    for side, table, layers in (("encoder", _HF_ENC, enc["layers"]),
                                ("decoder", _HF_DEC, dec["layers"])):
        for ours, hf, tr in table:
            for i, t in enumerate(layers[ours]):
                put(f"model.{side}.layers.{i}.{hf}", t.T if tr else t)
    return sd


def write_safetensors(path: str, tensors: dict) -> None:
    """A `.safetensors` file: the 8-byte little-endian header length, the
    JSON header (padded to 8 bytes), then each tensor's raw bytes."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    dtypes = {np.dtype(np.float16): "F16", np.dtype(np.float32): "F32"}
    for name, a in tensors.items():
        header[name] = {"dtype": dtypes[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a).astype("<" + a.dtype.str[1:])
                    .tobytes())


def _cli(args, env, timeout=300):
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "openhush_tpu_torch.cli",
                        *args], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=timeout)
    return r, time.monotonic() - t0


def _in_thread(fn, *args):
    """Start fn(*args) on a thread; the returned join() gives its result,
    or raises what it raised."""
    box = {}

    def run():
        try:
            box["r"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised by join()
            box["e"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "e" in box:
            raise box["e"]
        return box["r"]

    return join


def _host_commands(env):
    """The host-only subcommands in a home of their own, in three chains
    at once (set before get before delete); each command's exit code must
    be 0. Returns the wall of the three chains."""
    chains = [[["config", "show"],
               ["config", "set", "transcription.model", EVAL_MODEL],
               ["config", "get", "transcription.model"]],
              [["secret", "set", "smoke", "s3cret"],
               ["secret", "get", "smoke"], ["secret", "delete", "smoke"]],
              [["api-key", "generate"], ["service", "status"],
               ["device", "list", "--format", "json"]]]
    out = {}

    def run_chain(chain):
        for args in chain:
            out[" ".join(args)] = _cli(args, env, timeout=120)

    t0 = time.monotonic()
    for join in [_in_thread(run_chain, c) for c in chains]:
        join()
    wall = time.monotonic() - t0
    for what, (r, secs) in out.items():
        check(r.returncode == 0, f"{what} exit {r.returncode}: "
              f"{r.stderr[-1500:]}")
    check(out["config get transcription.model"][0].stdout.strip()
          == EVAL_MODEL, "config set/get round trip")
    check(out["secret get smoke"][0].stdout.strip() == "s3cret",
          "secret set/get round trip")
    check(isinstance(json.loads(out["device list --format json"][0].stdout
                                .strip().splitlines()[-1]), list),
          "device list --format json")
    log(f"  host subcommands (beside `model convert`): {len(out)} commands, "
        f"exit 0 each, {wall:.1f} s in three chains at once ("
        + ", ".join(f"{w} {s:.1f} s" for w, (_, s) in out.items()) + ")")
    return wall


def phase_evaluate(weights, get_config, engine_mod, wer, tracing, tokenizer,
                   counters, tmp):
    """Phase 12 at large-v3-turbo's full width (d 1280, 128 mels, 32
    encoder and 4 decoder layers; random weights from SEED): the tree as an
    HF-named fp16 model.safetensors with its config.json; `model convert`
    in a subprocess (the port's own reader reads the file; every npz leaf
    the fp16 source widened, bit for bit), `model list`; a
    LibriSpeech-layout tree of 4 WAVs (5-12 s); an in-process
    `evaluate_librispeech` on the npz (under the launch counters: K1-K5's
    evaluate_launches), its aggregate against wer.aggregate of its
    hypotheses, those tokens against an engine on the source's
    fp16-rounded weights; two transcribes under tracing.profile (the
    Chrome trace names K1-K5); then the tree's references replaced by
    those hypotheses and `evaluate` in a subprocess with
    OPENHUSH_NO_FALLBACK=1 (the t=0 rung): WER 0 over all their words
    pins every word that the CLI transcribed; the host-only subcommands,
    beside `model convert` (which keeps one core busy; the card machine
    has 8). `counters`: K1-K5; returns their launches in the in-process
    pass."""
    from openhush_tpu_torch.audio.wav import load_wav, save_wav
    cfg = get_config(EVAL_MODEL)
    home, models, hf = (os.path.join(tmp, d) for d in ("home", "models",
                                                       "hf"))
    for d in (home, models, hf):
        os.makedirs(d)
    env = dict(os.environ, PYTHONPATH=ROOT, HOME=home,
               OPENHUSH_MODEL_DIR=models,
               XDG_CONFIG_HOME=os.path.join(home, ".config"),
               XDG_DATA_HOME=os.path.join(home, ".local", "share"),
               XDG_RUNTIME_DIR=home, OPENHUSH_NO_FALLBACK="1")
    for k in ("OPENHUSH_CONFIG", "OPENHUSH_DRAFT_MODEL",
              "OPENHUSH_ALLOW_RANDOM_INIT", "DBUS_SESSION_BUS_ADDRESS"):
        env.pop(k, None)

    t0 = time.monotonic()
    src = weights.init_params(cfg, torch.Generator("cuda").manual_seed(SEED))
    sd = hf_state_dict(cfg, src)
    write_safetensors(os.path.join(hf, "model.safetensors"), sd)
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump({"architectures": ["WhisperForConditionalGeneration"],
                   "d_model": cfg.n_audio_state,
                   "encoder_layers": cfg.n_audio_layer,
                   "decoder_layers": cfg.n_text_layer,
                   "encoder_attention_heads": cfg.n_audio_head,
                   "decoder_attention_heads": cfg.n_text_head,
                   "num_mel_bins": cfg.n_mels, "vocab_size": cfg.n_vocab,
                   "max_source_positions": cfg.n_audio_ctx,
                   "max_target_positions": cfg.n_text_ctx,
                   "torch_dtype": "float16"}, f)
    st_bytes = os.path.getsize(os.path.join(hf, "model.safetensors"))
    n_params = sum(a.size for a in sd.values())
    del sd
    write_s = time.monotonic() - t0

    host = _in_thread(_host_commands, env)
    r, convert_s = _cli(["model", "convert", EVAL_MODEL, "--hf-path", hf],
                        env)
    check(r.returncode == 0, f"model convert exit {r.returncode}: "
          f"{r.stderr[-3000:]}")
    model_list = _in_thread(_cli, ["model", "list"], env)
    npz = os.path.join(models, f"{EVAL_MODEL}.npz")
    t0 = time.monotonic()
    tree = weights.load_npz(npz)
    bad, n_leaves = [], 0

    def walk(prefix, node, ref):
        nonlocal n_leaves
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v, ref[k])
                continue
            n_leaves += 1
            want = ref[k].to(torch.float16).float()
            if (v.dtype != np.float32 or tuple(v.shape) != tuple(want.shape)
                    or not torch.equal(torch.from_numpy(v).cuda().view(
                        torch.int32), want.view(torch.int32))):
                bad.append(prefix + k)

    walk("", tree, src)
    leaf_s = time.monotonic() - t0
    log(f"  {EVAL_MODEL} as HF fp16 model.safetensors: {n_params} "
        f"parameters, {st_bytes / 2**30:.2f} GiB, written in {write_s:.1f} s; "
        f"`model convert` (subprocess, the port's reader) {convert_s:.1f} s "
        f"→ npz "
        f"{os.path.getsize(npz) / 2**30:.2f} GiB; {n_leaves} leaves, "
        f"{len(bad)} differing from the fp16 source widened "
        f"({leaf_s:.1f} s to check)")
    check(not bad, f"every npz leaf == the fp16 source widened ({bad[:4]})")
    del tree
    r, list_s = model_list()
    row = [ln for ln in r.stdout.splitlines()
           if ln.split()[:1] == [EVAL_MODEL]]
    check(r.returncode == 0 and len(row) == 1 and "[downloaded]" in row[0],
          f"model list shows {EVAL_MODEL} converted: {r.stdout}")

    # A LibriSpeech-layout tree and a word vocabulary beside the npz.
    chapter = os.path.join(tmp, "libri", "1089", "134686")
    os.makedirs(chapter)
    for i, secs in enumerate(EVAL_SECS):
        save_wav(os.path.join(chapter, f"1089-134686-{i:04d}.wav"),
                 speechlike(secs, SEED + 120 + i))
    trans = os.path.join(chapter, "1089-134686.trans.txt")
    with open(trans, "w") as f:
        f.writelines(f"1089-134686-{i:04d} {t}\n"
                     for i, t in enumerate(EVAL_REFS))
    word_vocab(os.path.join(models, "vocab.json"),
               tokenizer.WhisperTokenizer(cfg.n_langs).special.eot)

    class Recorder:
        """The engine, each result kept."""

        def __init__(self, eng):
            self.eng, self.results = eng, []

        def transcribe(self, audio, **kw):
            self.results.append(self.eng.transcribe(audio, **kw))
            return self.results[-1]

    ladder = engine_mod.TEMPERATURES
    engine_mod.TEMPERATURES = (0.0,)
    try:
        with _env(OPENHUSH_MODEL_DIR=models, OPENHUSH_DRAFT_MODEL=None):
            t0 = time.monotonic()
            eng = engine_mod.WhisperEngine(EVAL_MODEL)
            load_s = time.monotonic() - t0
            rec = Recorder(eng)
            for fn in counters:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            agg = wer.evaluate_librispeech(rec, os.path.join(tmp, "libri"),
                                           progress=False)
            torch.cuda.synchronize()
            pass_s = time.monotonic() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            refs = [t for _, t in wer.iter_librispeech(os.path.join(tmp,
                                                                    "libri"))]
            hyps = [res.text for res in rec.results]
            recomputed = wer.aggregate(wer.wer(a, b) for a, b in
                                       zip(refs, hyps))
            tokens = [[s.tokens for s in res.segments] for res in rec.results]
            n_windows = sum(res.windows for res in rec.results)
            audios = [load_wav(p) for p, _ in
                      wer.iter_librispeech(os.path.join(tmp, "libri"))]
            del eng, rec
            # The source tree rounded to fp16 as written, then to the
            # engine's bf16, injected.
            seng = engine_mod.WhisperEngine(EVAL_MODEL, params=_cast_tree(
                _cast_tree(src, torch.float16), torch.bfloat16))
            del src
            source_tokens = [[s.tokens for s in seng.transcribe(
                a, language="en").segments] for a in audios]
            # Two transcribes under the profiler: the trace names the
            # kernels. A warm profiler can miss the CUDA activity of the
            # first launches after it starts (a run of the whole script
            # missed K1, the first), so a few small ops go first.
            prof_dir = os.path.join(tmp, "profile")
            for fn in counters:
                fn.launches = 0
            t0 = time.monotonic()
            with tracing.profile(prof_dir):
                warm = torch.zeros(1024, device="cuda")
                for _ in range(8):
                    warm.add_(1)
                torch.cuda.synchronize()
                for a in audios[:2]:
                    seng.transcribe(a, language="en", max_new_tokens=8)
                torch.cuda.synchronize()
            prof_s = time.monotonic() - t0
            in_block = [fn.launches for fn in counters]
            del seng
    finally:
        engine_mod.TEMPERATURES = ladder
    with open(os.path.join(prof_dir, "trace.json")) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]

    # The in-process hypotheses become the references: the CLI's WER is 0
    # over all their words only if it transcribed each word the same.
    hyp_refs = [wer.normalize_text(h) for h in hyps]
    with open(trans, "w") as f:
        f.writelines(f"1089-134686-{i:04d} {t}\n"
                     for i, t in enumerate(hyp_refs))
    r, eval_s = _cli(["evaluate", "--dataset", os.path.dirname(
        os.path.dirname(chapter)), "--model", EVAL_MODEL], env, timeout=600)
    check(r.returncode == 0, f"evaluate exit {r.returncode}: "
          f"{r.stderr[-3000:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    found = {k: sum(v in n for n in names)
             for k, v in TRACE_KERNELS.items()}

    n_tok = [sum(len(t) for t in r) for r in tokens]
    log(f"  evaluate (subprocess, bf16, t=0, the in-process hypotheses as "
        f"references): {eval_s:.1f} s, {got}; `model list` {list_s:.1f} s")
    log(f"  in process: engine load {load_s:.1f} s, the pass {pass_s:.2f} s "
        f"over {sum(EVAL_SECS):.1f} s of audio ({sum(EVAL_SECS) / pass_s:.3f}"
        f" audio s a wall s), tokens a file {n_tok}, launches {launches}; "
        f"hypotheses' words {[len(h.split()) for h in hyps]}; against the "
        f"tree's own references {vars(agg)}")
    log(f"  profile of two transcribes (8 tokens each): {prof_s:.1f} s with "
        f"the export, {len(names)} kernel events; K1-K5 in the trace "
        f"{found}, launched in the block {in_block}")
    check(vars(recomputed) == vars(agg),
          "evaluate_librispeech == wer.aggregate of the engine's hypotheses "
          f"({vars(agg)})")
    n_hyp_words = sum(len(h.split()) for h in hyp_refs)
    check(n_hyp_words > 0 and got == {
              "wer": 0.0, "substitutions": 0, "deletions": 0,
              "insertions": 0, "n_ref_words": n_hyp_words,
              "model": EVAL_MODEL},
          "the evaluate CLI's transcripts == the in-process engine's, word "
          f"for word ({n_hyp_words} words)")
    check(tokens == source_tokens,
          "the converted npz's tokens == the fp16 source weights' tokens")
    k1, k2, k3, k4, k5 = (launches[fn.__name__] for fn in counters)
    check(k1 == n_windows and k2 == cfg.n_audio_layer * k1
          and k3 == cfg.n_text_layer * k1 and k4 == k5 > 0,
          f"the evaluate pass ran K1-K5 on the card: K1 once a window "
          f"({n_windows}), K2 once an encoder layer, K3 once a decoder "
          f"layer, K4 = K5 ({launches})")
    check(all(found.values()), f"the profiler trace names K1-K5: {found}")
    log("  in the trace: " + "; ".join(
        next(n for n in names if TRACE_KERNELS[k] in n)[:80] for k in found))
    host_s = host()
    log(f"  walls: write {write_s:.1f} s, convert {convert_s:.1f} s, "
        f"evaluate CLI {eval_s:.1f} s, in-process pass {pass_s:.1f} s "
        f"(+ load {load_s:.1f} s), host subcommands {host_s:.1f} s")
    return launches


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def phase_cli():
    """The CLI in its own process, on one file (greedy, --beam-size 5 and
    --draft) and on three (the serving path): the four processes run at
    once (each loads its own large-v3; run one after another they took
    ~120 s, mostly Python, torch and the weights' set-up).
    OPENHUSH_NO_FALLBACK=1 keeps them to the t=0 rung: on random weights
    the ladder would run all six."""
    from openhush_tpu_torch.audio.wav import save_wav
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "request.wav")
        save_wav(wav, speechlike(10.0, SEED + 4))
        wavs = []
        for i, secs in enumerate((6.0, 9.0, 12.0)):
            wavs.append(os.path.join(tmp, f"request{i}.wav"))
            save_wav(wavs[-1], speechlike(secs, SEED + 30 + i))
        env = dict(os.environ, PYTHONPATH=ROOT, OPENHUSH_NO_FALLBACK="1")
        runs = {" ".join(["CLI", *extra]): [wav, *extra] for extra in (
            [], ["--beam-size", str(BEAM)], ["--draft", "large-v3-turbo"])}
        runs["CLI, 3 files through the server"] = wavs
        t0 = time.monotonic()
        procs = {what: subprocess.Popen(
            [sys.executable, "-m", "openhush_tpu_torch.cli", "transcribe",
             *args, "--model", "large-v3", "--random-init", "--format",
             "json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=ROOT) for what, args in runs.items()}
        try:
            outs = {what: p.communicate(timeout=600)
                    for what, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.monotonic() - t0
    for what, p in procs.items():
        out, err = outs[what]
        check(p.returncode == 0, f"{what} exit {p.returncode}: "
              f"{err[-2000:]}")
        data = json.loads(out)
        if what.startswith("CLI, 3 files"):
            check(isinstance(data, list) and [d["file"] for d in data] == wavs
                  and [d["audio_duration_secs"] for d in data]
                  == [6.0, 9.0, 12.0], "multi-file CLI JSON list")
            log(f"  {what}: rc 0, languages "
                f"{[d['language'] for d in data]}")
            log(json.dumps(data))
            continue
        check(data["model"] == "large-v3"
              and data["audio_duration_secs"] == 10.0, f"{what} JSON")
        log(f"  {what}: rc 0, language {data['language']}, "
            f"real_time_factor {data['real_time_factor']:.4f} (beside the "
            f"other three)")
    log(f"  the four CLI processes at once: {wall:.1f} s")


# The tensor-core kernels, by their mangled names' kernel and template
# arguments: K2 in bf16 (NP = 1) and fp32 (NP = 3), K6 and K7 in fp32.
TC_KERNELS = {
    "K2 bf16": "25flash_attention_tc_kernelILi1E",
    "K2 fp32": "25flash_attention_tc_kernelILi3E",
    "K6 fp32": "23flash_bwd_dkv_tc_kernelIfLi3E",
    "K7 fp32": "22flash_bwd_dq_tc_kernelIfLi3E",
}


def phase_sass(so, nvcc: str) -> None:
    """K2 (bf16 and fp32), K6 and K7 run on the tensor cores: count each
    one's warpgroup MMA instructions (HGMMA) in the built library's SASS,
    by the toolkit's cuobjdump, and fail if one has none or if cuobjdump is
    missing."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    check(os.path.exists(cuobjdump), f"{cuobjdump} exists (the SASS check)")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts = dict.fromkeys(TC_KERNELS, 0)
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k, name in TC_KERNELS.items()
                            if name in line), None)
        elif current is not None and "HGMMA" in line:
            counts[current] += 1
    for name, count in counts.items():
        log(f"  {name} SASS: {count} HGMMA (wgmma) instructions")
        check(count > 0, f"{name} on the tensor cores (HGMMA in its SASS)")


# ---------------------------------------------------------------------------
# Phase 13: multi-device
# ---------------------------------------------------------------------------

MULTICHIP_STEPS = 32          # greedy batcher steps of the large-v3 stage
MULTICHIP_TRAIN = (2, 64)     # the train step's batch and tokens
MULTICHIP_BIAS = 0.05         # std of the random linear biases (init's are 0)
# The first greedy step's filtered logits, 1x2 against one rank (the same
# inputs on both sides): limits set from the readings without biases
# (bf16 0.0097, fp32 1.3e-5, steps 0-2), about 4x and 8x above them. The
# control, the row-parallel biases counted twice, must fail the bf16 one.
MULTICHIP_LOGITS_TOL = {"bf16": 0.04, "fp32": 1e-4}
ROW_BIASES = ("o_b", "xo_b", "fc2_b")


def _multichip_serve(cfg, params, state, mel_audio, prompt, suppress,
                     stage, steps=MULTICHIP_STEPS):
    """30 s of audio → K1 → encode → int8 cross-KV → prefill (admit) →
    `steps` greedy steps on one slot, in the state's dtype; each stage's
    wall and all-reduces into `stage`. Returns the slot's tokens and the
    filtered logits each step chose from ([steps, V])."""
    from openhush_tpu_torch.models.whisper import model as whisper
    from openhush_tpu_torch.ops import frontend
    from openhush_tpu_torch.parallel import sharding as sh
    from openhush_tpu_torch.runtime import batcher

    def timed(name, fn):
        calls, nbytes = sh.all_reduce.calls, sh.all_reduce.bytes
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        stage[name] = {"s": time.monotonic() - t0,
                       "all_reduces": sh.all_reduce.calls - calls,
                       "bytes": sh.all_reduce.bytes - nbytes}
        return out

    mel = timed("k1", lambda: frontend.log_mel(mel_audio, n_mels=cfg.n_mels))
    feats = timed("encode", lambda: whisper.encode(
        cfg, params, mel.to(state.cache_k.dtype)))
    xkv = timed("cross_kv", lambda: whisper.compute_cross_kv_quant(
        cfg, params, feats))
    timed("prefill", lambda: batcher.admit(
        cfg, params, state, 0, xkv, prompt, False, prompt_len=len(prompt)))
    chosen, choose = [], batcher._choose_tokens

    def recording_choose(lg, st, rows=None):
        chosen.append(lg[0].float())
        return choose(lg, st, rows)

    batcher._choose_tokens = recording_choose
    try:
        timed("steps", lambda: [batcher.step(cfg, params, state, suppress,
                                             inner_steps=1)
                                for _ in range(steps)])
    finally:
        batcher._choose_tokens = choose
    n = int(state.pos[0])
    return (state.tokens[0, :n].cpu().numpy(),
            torch.stack(chosen).cpu().numpy())


def multichip_rank(seed: int) -> dict:
    """A rank of phase 13's large-v3 stage on a 1x2 mesh (two ranks). Rank
    0 first runs the stage on the whole model, as one rank (the reference);
    then both run it with the model split over them. Returns the tokens,
    logits, losses and norms, launch counts (the sharded run only), walls,
    all-reduces and peak memory, and the control's first-step logits."""
    import torch.distributed as dist
    from openhush_tpu_torch.models.whisper import decoding, weights
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.ops import (decode_attention as da,
                                        flash_attention as fa, frontend,
                                        mel as mel_ops, quantize)
    from openhush_tpu_torch.parallel import sharding as sh
    from openhush_tpu_torch.runtime import batcher
    from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
    from openhush_tpu_torch.training import train

    counters = (frontend.log_mel_energies, fa.flash_attention,
                quantize.quantize_heads_kv, da.attend_decode,
                da.attend_decode_pipelined, fa.flash_attention_lse,
                fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq,
                fa.split_planes)
    rank = dist.get_rank()
    cfg = get_config("large-v3")
    mesh = sh.create_mesh(2, "cuda")
    dev = mesh.device
    tok = WhisperTokenizer(cfg.n_langs)
    prompt = tok.sot_sequence("en", "transcribe", timestamps=False)
    suppress = torch.from_numpy(decoding.build_suppress_mask(
        tok, cfg, decoding.DecodingOptions())).to(dev)
    audio = torch.from_numpy(mel_ops.pad_or_trim(speechlike(30.0, seed))
                             ).to(dev)[None]
    B, S = MULTICHIP_TRAIN
    rng = np.random.default_rng(seed)
    clips = torch.from_numpy(np.stack([mel_ops.pad_or_trim(
        speechlike(8.0 + 4 * i, seed + 1 + i)) for i in range(B)])).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.n_vocab, (B, S))).to(dev)
    targets = torch.roll(tokens, -1, 1)
    targets[:, :3] = train.IGNORE_ID
    targets[0, S // 2:] = train.IGNORE_ID           # row 0 padded
    out: dict = {"rank": rank, "coordinate": mesh.coordinate,
                 "prompt_len": len(prompt)}

    def init(dtype):
        """Random weights from the seed, with random linear biases (fp32
        draws, then cast: the bf16 and fp32 trees are one model)."""
        params = weights.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dtype, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        for part in ("encoder", "decoder"):
            for name, t in params[part]["layers"].items():
                if name.endswith("_b"):
                    t.copy_(MULTICHIP_BIAS * torch.randn(
                        t.shape, generator=g, device=dev))
        return params

    def train_step(params, stage):
        mel = frontend.log_mel(clips, n_mels=cfg.n_mels)
        opt = train.make_optimizer(lr=1e-5, warmup_steps=1)
        state = opt.init(params)
        calls, nbytes = sh.all_reduce.calls, sh.all_reduce.bytes
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss, grads = train.value_and_grad(cfg, params, mel, tokens, targets)
        gnorm = train.global_norm(grads, params)
        opt.apply(params, grads, state)
        torch.cuda.synchronize()
        stage["train_step"] = {"s": time.monotonic() - t0,
                               "all_reduces": sh.all_reduce.calls - calls,
                               "bytes": sh.all_reduce.bytes - nbytes}
        return float(loss), float(gnorm)

    def new_state(dtype=torch.bfloat16):
        return batcher.init_state(cfg, 1, dtype=dtype, device=dev)

    with torch.no_grad():
        full = init(torch.bfloat16)
        sharded = sh.shard_params(full, mesh)
        if rank == 0:
            out["ref_stage"] = {}
            out["ref_tokens"], out["ref_logits"] = _multichip_serve(
                cfg, full, new_state(), audio, prompt, suppress,
                out["ref_stage"])
        del full
    torch.cuda.empty_cache()
    if rank == 0:
        # The train step's first update has lr 0: the fp32 weights serve
        # the fp32 greedy run after it unchanged.
        full = init(torch.float32)
        sharded32 = sh.shard_params(full, mesh)
        out["ref_loss"], out["ref_gnorm"] = train_step(full, out["ref_stage"])
        with torch.no_grad():
            out["ref32_tokens"], out["ref32_logits"] = _multichip_serve(
                cfg, full, new_state(torch.float32), audio, prompt, suppress,
                {})
        del full
    dist.barrier()
    if rank != 0:
        sharded32 = sh.shard_params(init(torch.float32), mesh)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    out["stage"] = {}
    with torch.no_grad():
        out["tokens"], out["logits"] = _multichip_serve(
            cfg, sharded, sh.shard_slot_state(new_state(), sharded, 1), audio,
            prompt, suppress, out["stage"])
    del sharded
    out["loss"], out["gnorm"] = train_step(sharded32, out["stage"])
    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # Not counted: the same greedy run in fp32, where near-ties are rarer;
    # then the control, the bf16 run's first step with the row-parallel
    # biases counted twice (as a bias added on both ranks before the
    # reduce would be).
    out["stage32"] = {}
    with torch.no_grad():
        out["tokens32"], out["logits32"] = _multichip_serve(
            cfg, sharded32, sh.shard_slot_state(new_state(torch.float32),
                                                sharded32, 1),
            audio, prompt, suppress, out["stage32"])
        del sharded32
        twice = sh.shard_params(init(torch.bfloat16), mesh)
        for part in ("encoder", "decoder"):
            layers = twice[part]["layers"]
            for name in set(ROW_BIASES) & set(layers):
                layers[name] *= 2
        _, out["bias_twice_logits"] = _multichip_serve(
            cfg, twice, sh.shard_slot_state(new_state(), twice, 1), audio,
            prompt, suppress, {}, steps=1)
    return out


def check_local_heads(H: int) -> None:
    """K2-K5, K6 and K7 at a model rank's head count of large-v3 (H of its
    20 heads, 64 wide), at the shapes the rank's path gives them, against
    their plain versions with the tolerances of the 20-head phases: K2 in
    bf16 (B=1, T=1500, the projection layout) and in its fp32 residual
    mode with K6 and K7 (B=2, the train step's batch); K3 on one window's
    cross K and V; K4 on the bf16 self-cache (448 rows, causal, the greedy
    step's mode); K5 on the int8 cross-KV. Run outside the ranks: their
    launches are not counted."""
    from openhush_tpu_torch.ops import (decode_attention as da,
                                        flash_attention as fa, quantize)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 130)
    D, T, T_self = 64, 1500, 448
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    heads = lambda B, dtype: rnd(B, T, H * D).to(dtype).view(
        B, T, H, D).transpose(1, 2)
    what = f"{H} heads, the 1x2 rank's"

    q, k, v = (heads(1, torch.bfloat16) for _ in range(3))
    e = (fa.flash_attention(q, k, v).float() - fa.attend(q, k, v).float()
         ).abs().max().item()
    log(f"K2 flash_attention (bf16, B=1, T={T}, {what}): max_abs_err "
        f"{e:.3e} (tolerance 1e-2)")
    check(e <= 1e-2, f"K2 bf16 vs plain at {H} heads")

    q, k, v, do = (heads(MULTICHIP_TRAIN[0], torch.float32) for _ in range(4))
    o, lse = fa.flash_attention_lse(q, k, v)
    o_plain, lse_plain = fa.attend_lse(q, k, v)
    delta = fa.delta_rows(o, do)
    rest = (do, lse, delta)
    rel = [(a - b).abs().max().item() / b.abs().max().item() for a, b in
           zip((*fa.flash_attention_bwd_dkv(q, k, v, *rest),
                fa.flash_attention_bwd_dq(q, k, v, *rest)),
               (*fa.backward_dkv_plain(q, k, v, *rest),
                fa.backward_dq_plain(q, k, v, *rest)))]
    errs = [(o - o_plain).abs().max().item(),
            (lse - lse_plain).abs().max().item()]
    log(f"K2 residual mode (fp32, B={MULTICHIP_TRAIN[0]}, T={T}, {what}): "
        f"output max_abs_err {errs[0]:.3e}, lse {errs[1]:.3e} (tolerance "
        f"1e-4); K6/K7: max_abs_err / max|plain| dk {rel[0]:.3e}, dv "
        f"{rel[1]:.3e}, dq {rel[2]:.3e} (tolerance 1e-4)")
    check(max(errs) <= 1e-4, f"K2 residual mode vs plain at {H} heads")
    check(max(rel) <= 1e-4, f"K6/K7 vs plain at {H} heads")

    k, v = ((scale * rnd(1, T, H * D)).to(torch.bfloat16)
            for scale in (3.0, 1.0))
    check_k3(quantize, k, v, H)

    q = rnd(1, 1, H * D).to(torch.bfloat16)
    k, v = (rnd(1, T_self, H * D).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([37], dtype=torch.int32, device=dev)
    e = (da.attend_decode(q, k, v, lengths, H, causal=True).float()
         - da.attend_decode_plain(q, k, v, lengths, H, causal=True).float()
         ).abs().max().item()
    log(f"K4 attend_decode (bf16 self, T={T_self}, causal, {what}): "
        f"max_abs_err {e:.3e} (tolerance 1e-2)")
    check(e <= 1e-2, f"K4 bf16 self-attention vs plain at {H} heads")

    (k8, ks), (v8, vs) = (quantize.quantize_heads_plain(
        rnd(1, T, H * D).to(torch.bfloat16), H) for _ in range(2))
    o, p = da.attend_decode_pipelined(q, k8, v8, None, H, ks=ks, vs=vs,
                                      return_probs=True)
    plain, p_plain = da.attend_decode_plain(q, k8, v8, None, H, ks=ks,
                                            vs=vs, return_probs=True)
    e = (o.float() - plain.float()).abs().max().item()
    dp = (p - p_plain).abs()
    share = dp.ne(0).sum().item() / (H * T)
    log(f"K5 attend_decode_pipelined (int8 cross, T={T}, {what}): "
        f"max_abs_err {e:.3e} (tolerance 1e-2); int8 prob levels max diff "
        f"{dp.max().item():.0f} on {share:.2e} of keys (tolerance 1 level "
        f"on <= 1e-3)")
    check(e <= 1e-2 and dp.max().item() <= 1 and share <= 1e-3,
          f"K5 int8 cross-attention vs plain at {H} heads")


def first_step_logits(what, ours, theirs, tol):
    """The first greedy step's filtered logits against one rank's (the
    same inputs on both sides) → max |d|, logged beside `tol`."""
    err = float(np.abs(ours[0] - theirs[0]).max())
    log(f"  {what}: first step's filtered logits max |d| {err:.4g} against "
        f"one rank's (limit {tol})")
    return err


def greedy_agreement(what, ours, theirs, ours_logits, theirs_logits, P):
    """Greedy tokens against one rank's: equal up to the first step whose
    top-two margin (in one rank's filtered logits) is under 4x the logits'
    error (phase 4f's rule), that error measured on the steps up to the
    first that differs (their inputs are the same). Logs and checks."""
    ours, theirs = ours[P:], theirs[P:]
    n = min(len(ours), len(theirs))
    first = next((j for j in range(n) if ours[j] != theirs[j]), n)
    equal = first == n and len(ours) == len(theirs)
    err = float(np.abs(ours_logits[:first + 1]
                       - theirs_logits[:first + 1]).max())
    top2 = np.sort(theirs_logits, axis=1)[:, -2:]
    tie = next((j for j, m in enumerate(top2[:, 1] - top2[:, 0])
                if m < 4 * err), len(top2))
    log(f"  {what}: {len(ours)} tokens against one rank's {len(theirs)}, "
        + ("equal" if equal else f"parting at step {first}")
        + f"; filtered logits max |d| {err:.4g} up to there; first top-two "
        f"margin under 4x that at step {tie if tie < len(top2) else 'none'}")
    check(equal or first >= tie, f"{what}: tokens equal one rank's up to "
          f"the first near-tie")
    return equal


def phase_multichip(dryrun, world, get_config) -> dict:
    """(a) dryrun_multichip(8) on the card: 4x2, then 1x2 and 2x2, each
    stage held to a mesh of one rank; K2-K7 at the 1x2 rank's 10 heads
    against their plain versions; (b) large-v3 at full width on a 1x2 mesh
    against one rank. Returns each K1-K7 counter's launches per rank in
    (b)."""
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 8 else "gloo"
    log(f"  torch.cuda.device_count() = {cards}; the dry run's 8 ranks on "
        f"{backend}" + ("" if backend == "nccl" else
                        f" ({8 // cards if cards < 8 else 1} a card; CUDA "
                        f"tensors through the host)"))
    t = time.monotonic()
    report = dryrun.dryrun_multichip(8, "cuda", backend=backend)
    check([r["mesh"] for r in report] == ["4x2", "1x2", "2x2"]
          and len(report[0]["stages"]) == 5,
          "the dry run ran five stages on 4x2 and the reduced pass on 1x2 "
          "and 2x2")
    log(f"  multichip (a) dry run: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    cfg = get_config("large-v3")
    check_local_heads(cfg.n_text_head // 2)
    log(f"  multichip kernels at 10 heads: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    backend = "nccl" if cards >= 2 else "gloo"
    log(f"  large-v3 on a 1x2 mesh: 2 ranks on {backend}"
        + (", a card a rank" if backend == "nccl" else ", on one card"))
    res = world.run_world(multichip_rank, 2, SEED, device="cuda",
                          backend=backend)
    ref = res[0]
    for r in res:
        log(f"  rank {r['rank']} {r['coordinate']}: peak "
            f"{r['peak_gib']:.2f} GiB; launches {r['launches']}")
        for name, s in r["stage"].items():
            per = (f", {s['s'] / MULTICHIP_STEPS * 1e3:.2f} ms and "
                   f"{s['all_reduces'] / MULTICHIP_STEPS:.0f} all-reduces "
                   f"({s['bytes'] / MULTICHIP_STEPS:.0f} B) a step"
                   if name == "steps" else "")
            log(f"    {name}: {s['s']:.3f} s, {s['all_reduces']} "
                f"all-reduces, {s['bytes'] / 2**20:.2f} MiB{per}")
    for name, s in ref["ref_stage"].items():
        log(f"    one rank, {name}: {s['s']:.3f} s")
    L_enc, L_dec = cfg.n_audio_layer, cfg.n_text_layer
    want = {"log_mel_energies": 2, "flash_attention": L_enc,
            "quantize_heads_kv": L_dec,
            "attend_decode": L_dec * (1 + MULTICHIP_STEPS),
            "attend_decode_pipelined": L_dec * (1 + MULTICHIP_STEPS),
            "flash_attention_lse": L_enc, "flash_attention_bwd_dkv": L_enc,
            "flash_attention_bwd_dq": L_enc, "split_planes": 2 * L_enc}
    for r in res:
        check(r["launches"] == want,
              f"rank {r['rank']} launched K1-K7 as the layers predict: "
              f"{r['launches']} against {want}")
        check(np.array_equal(r["tokens"], res[0]["tokens"])
              and np.array_equal(r["logits"], res[0]["logits"]),
              "both model ranks chose from the same logits (lockstep)")
        check(r["stage"]["steps"]["all_reduces"]
              == 3 * L_dec * MULTICHIP_STEPS,
              "three all-reduces a decoder layer and step (o, xo, fc2)")
    # Greedy on random weights meets near-ties (random logits crowd the
    # top), and bf16 rounds the two runs' sums apart: hold the tokens to
    # one rank's up to the first near-tie, in bf16 (the main path) and in
    # fp32, where the error is ~1e-5 and all tokens must be equal.
    tol = MULTICHIP_LOGITS_TOL
    check(first_step_logits("large-v3 1x2 greedy, bf16", res[0]["logits"],
                            ref["ref_logits"], tol["bf16"]) <= tol["bf16"],
          "the bf16 first step's logits within the limit of one rank's")
    check(first_step_logits("large-v3 1x2 greedy, fp32", res[0]["logits32"],
                            ref["ref32_logits"], tol["fp32"]) <= tol["fp32"],
          "the fp32 first step's logits within the limit of one rank's")
    check(first_step_logits("control, row-parallel biases counted twice",
                            res[0]["bias_twice_logits"], ref["ref_logits"],
                            tol["bf16"]) > tol["bf16"],
          "the control fails the bf16 limit")
    P = ref["prompt_len"]
    greedy_agreement("large-v3 1x2 greedy, bf16", res[0]["tokens"],
                     ref["ref_tokens"], res[0]["logits"], ref["ref_logits"],
                     P)
    check(greedy_agreement("large-v3 1x2 greedy, fp32", res[0]["tokens32"],
                           ref["ref32_tokens"], res[0]["logits32"],
                           ref["ref32_logits"], P),
          "the fp32 1x2 tokens equal one rank's, all of them")
    check(np.array_equal(res[1]["tokens32"], res[0]["tokens32"]),
          "both model ranks chose the same fp32 tokens (lockstep)")
    log(f"  fp32 greedy steps on 1x2: "
        f"{res[0]['stage32']['steps']['s'] / MULTICHIP_STEPS * 1e3:.2f} ms "
        f"a step")
    loss_err = max(abs(r["loss"] - ref["ref_loss"]) for r in res)
    gnorm_err = max(abs(r["gnorm"] / ref["ref_gnorm"] - 1) for r in res)
    log(f"  large-v3 1x2 fp32 train step against one rank: loss "
        f"{res[0]['loss']:.6f} against {ref['ref_loss']:.6f} "
        f"(|d| {loss_err:.3g}), gradient norm {res[0]['gnorm']:.6f} "
        f"against {ref['ref_gnorm']:.6f} (relative {gnorm_err:.3g})")
    check(loss_err <= 2e-4, "the fp32 train step's loss within 2e-4 of one "
          "rank's")
    check(gnorm_err <= 1e-4, "the gradient norm within 1e-4 (relative) of "
          "one rank's")
    check(res[0]["loss"] == res[1]["loss"] and res[0]["gnorm"]
          == res[1]["gnorm"], "both model ranks hold the same loss and norm")
    log(f"  multichip (b) large-v3 1x2: {time.monotonic() - t:.1f} s")
    return {name: [r["launches"][name] for r in res] for name in want}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from openhush_tpu_torch.models.whisper import (beam, decoding,
                                                   speculative, weights)
    from openhush_tpu_torch.models.whisper import model as whisper
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.models import (diarization, m2m100, silero, vad,
                                           wakeword)
    from openhush_tpu_torch.ops import (_build, decode_attention, denoise,
                                        dsp, flash_attention, frontend, mel,
                                        quantize, w8a16)
    from openhush_tpu_torch import cli
    from openhush_tpu_torch.audio import capture
    from openhush_tpu_torch.runtime import (batcher, daemon, ipc, longform,
                                            recording)
    from openhush_tpu_torch.runtime import server as server_mod
    from openhush_tpu_torch.text import tokenizer
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    from openhush_tpu_torch.runtime.server import EngineServer
    from openhush_tpu_torch.training import data, distill, speaker, train
    from openhush_tpu_torch.runtime import engine as engine_mod
    from openhush_tpu_torch.utils import der, onnx_io, tracing, wer
    from openhush_tpu_torch.parallel import dryrun, world

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
    int8_rows = phase_int8_self_cache(decode_attention, quantize)
    beam_rows = phase_beam_attention(decode_attention, quantize)
    spec_rows = phase_spec_attention(decode_attention, quantize)
    multi_row = phase_multi_attention(decode_attention, quantize)
    w8_row = phase_w8a16(w8a16, whisper)
    dsp_rows = phase_dsp_kernels(dsp, denoise)
    daemon_shapes = phase_daemon_shapes(frontend, flash_attention,
                                        decode_attention, quantize, mel)
    for r in rows[:5]:
        for T, m in daemon_shapes.get(r["name"], {}).items():
            r.update({f"ctx{T}_{k}": v for k, v in m.items()})
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
    phase_int8_tiny(WhisperEngine, EngineServer, batcher, whisper, weights,
                    get_config, frontend, mel)
    phase_beam_tiny(beam, decoding, whisper, weights, get_config, frontend,
                    mel)
    phase_spec_tiny(speculative, decoding, whisper, weights, get_config,
                    frontend, mel, EngineServer)
    log(f"phase 3 tiny fp32 card vs CPU, server vs one-shot, training, int8 "
        f"rungs, beam, speculative: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    counters = [r["counter"] for r in rows] + [w8a16.mm_w8a16]
    n_layer = get_config("large-v3").n_text_layer
    eng = WhisperEngine("large-v3", dtype="bfloat16", allow_random_init=True)
    _, xrt_bf16 = phase_main_path(eng, whisper, counters, n_layer)
    log(f"phase 4 one-shot path: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    call_bf16 = phase_trace(eng, decoding, whisper, frontend)
    log(f"phase 4b decode trace: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    launches, _ = phase_serving(eng, longform, whisper, counters, n_layer)
    log(f"phase 4c serving path: {time.monotonic() - t:.1f} s")

    # 4c-audio: the daemon's audio front on the same bf16 weights.
    t = time.monotonic()
    dsp_launches = phase_audio_front(eng, longform, dsp, denoise, daemon, vad,
                                     silero, wakeword, counters)
    for r in dsp_rows:
        r["launches"] = dsp_launches[r["counter"].__name__]
    log(f"phase 4c-audio audio front: {time.monotonic() - t:.1f} s")

    # 4d: the int8 rungs on the same weights: int8 decoder weights and the
    # W8A8 encoder in the one-shot engine, then the server with an int8
    # self-cache on them.
    t = time.monotonic()
    eng8 = WhisperEngine("large-v3", params=eng.params, quantize_weights=True,
                         quantize_encoder=True)
    check(isinstance(eng8.params["decoder"]["layers"]["q_w"], dict)
          and isinstance(eng8.params["encoder"]["layers"]["q_w"], dict),
          "the int8 rungs quantized the decoder and encoder weights")
    log("  int8 rungs: one-shot engine (int8 decoder weights, W8A8 encoder)")
    # The 20 s request alone (a depth cut that keeps the script inside its
    # time limit).
    launches1, xrt8 = phase_main_path(eng8, whisper, counters, n_layer,
                                      secs=(20.0,))
    call8 = phase_trace(eng8, decoding, whisper, frontend)
    dev_ms = lambda c: ("not measured" if c["device_ms"] is None
                        else f"{c['device_ms']:.3f} ms")
    log(f"  int8 decoder weights (W8A16) against bf16 (phase 4): a decoder "
        f"call {dev_ms(call8)} of device time against {dev_ms(call_bf16)}, "
        f"{call8['host_ms']:.2f} ms of host wall against "
        f"{call_bf16['host_ms']:.2f} "
        f"({call8['host_ms'] / call_bf16['host_ms']:.2f}x); the one-shot "
        f"20 s request {xrt8:.2f}x realtime against phase 4's "
        f"{xrt_bf16:.2f}x ({xrt8 / xrt_bf16:.2f} of it)")
    w8_row.update(launches=launches1["mm_w8a16"],
                  int8_call_device_ms=call8["device_ms"],
                  bf16_call_device_ms=call_bf16["device_ms"],
                  int8_call_host_ms=call8["host_ms"],
                  bf16_call_host_ms=call_bf16["host_ms"],
                  int8_xrt=xrt8, bf16_xrt=xrt_bf16)
    phase_int8_encoder(eng, eng8, whisper, frontend)
    log("  int8 rungs: server with an int8 self-cache on those weights")
    launches8, flat8 = phase_serving(eng8, longform, whisper, counters,
                                     n_layer, int8_self_cache=True)
    for r in int8_rows:
        r["launches"] = launches8[r["counter"].__name__]
    int8_rows[1]["self_write_launches"] = n_layer * flat8
    w8_row["server_launches"] = launches8["mm_w8a16"]
    del eng8
    log(f"phase 4d int8 rungs: {time.monotonic() - t:.1f} s")

    # 4e: beam search on the same bf16 weights.
    t = time.monotonic()
    beam_launches = phase_beam(eng, longform, beam, whisper, frontend,
                               counters + [decode_attention.attend_decode_beam,
                                           decode_attention.attend_decode_multi],
                               n_layer)
    multi_row.update(launches=beam_launches["multi_server"],
                     oneshot_launches=beam_launches["multi_oneshot"],
                     int8_self_launches=beam_launches["multi_int8_self"])
    beam_rows[0].update(launches=beam_launches["server"],
                        oneshot_launches=beam_launches["oneshot"],
                        int8_self_launches=beam_launches["int8_self"])
    log(f"phase 4e beam search: {time.monotonic() - t:.1f} s")

    # 4f: speculative decoding on the same bf16 weights, with a
    # large-v3-turbo-shaped draft (random weights seeded 1).
    t = time.monotonic()
    seng = WhisperEngine("large-v3", params=eng.params,
                         draft_model="large-v3-turbo", allow_random_init=True)
    del eng
    spec = phase_spec(seng, speculative, decoding, whisper, frontend,
                      counters + [decode_attention.attend_decode_multi],
                      n_layer, EngineServer, batcher)
    multi_row.update(verify_launches=spec["multi_oneshot"],
                     server_verify_launches=spec["multi_server"])
    for r, server in zip(spec_rows, ("server", "server_pipelined")):
        r.update(launches=spec["oneshot"], verify_launches=spec["verify"],
                 draft_launches=spec["draft"],
                 server_launches=spec[server],
                 server_verify_launches=spec["server_verify"])
    log(f"phase 4f speculative decoding: {time.monotonic() - t:.1f} s")

    # 4g: a large-v3-turbo-shaped draft distilled against the same bf16
    # weights, then run by the one-shot loop and a 1-slot spec server.
    t = time.monotonic()
    dist = phase_distill(seng, distill, speculative, decoding, whisper,
                         frontend, counters, n_layer, EngineServer, batcher,
                         get_config, spec["tie_threshold"])
    for r in rows[:5]:                      # K1-K5
        r["distill_launches"] = dist["launches"][r["counter"].__name__]
    del seng
    log(f"phase 4g draft distillation: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    phase_cli()
    log(f"phase 5 CLI: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    launches.update(phase_finetune(data, train, weights, get_config,
                                   flash_attention))
    log(f"phase 6 large-v3 fine-tune: {time.monotonic() - t:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        t = time.monotonic()
        phase_onnx(vad, wakeword, onnx_io, tmp)
        log(f"phase 7 ONNX executor: {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        phase_diarization(diarization, der, speaker, tmp)
        log(f"phase 8 diarization: {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    phase_m2m100(m2m100, train)
    log(f"phase 9 M2M-100 418M: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        daemon_launches = phase_daemon(
            daemon, ipc, server_mod, tokenizer, capture, cli,
            [r["counter"] for r in rows[:5]] + [dsp.limiter_gain], tmp)
    for r in rows[:5] + dsp_rows:
        if r["counter"].__name__ in daemon_launches:
            r["daemon_launches"] = daemon_launches[r["counter"].__name__]
    log(f"phase 10 dictation daemon: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        record_launches = phase_record(
            recording, diarization, speaker,
            [r["counter"] for r in rows[:5]], tmp)
    for r in rows[:5]:
        r["record_launches"] = record_launches[r["counter"].__name__]
    log(f"phase 11 record: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        evaluate_launches = phase_evaluate(
            weights, get_config, engine_mod, wer, tracing, tokenizer,
            [r["counter"] for r in rows[:5]], tmp)
    for r in rows[:5]:
        r["evaluate_launches"] = evaluate_launches[r["counter"].__name__]
    log(f"phase 12 convert and evaluate: {time.monotonic() - t:.1f} s")

    t = time.monotonic()
    multichip_launches = phase_multichip(dryrun, world, get_config)
    for r in rows:                          # K1-K7, per rank
        r["multichip_launches"] = multichip_launches[r["counter"].__name__]
    rows[1]["multichip_residual_launches"] = multichip_launches[
        "flash_attention_lse"]
    log(f"phase 13 multichip: {time.monotonic() - t:.1f} s")

    kernels = []
    for r in (rows + int8_rows + beam_rows + spec_rows + [multi_row]
              + dsp_rows + [w8_row]):
        fn = r.pop("counter")
        kernels.append({"name": r["name"], "route": "cuda",
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": (r["launches"] if "launches" in r
                                     else launches[fn.__name__]),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        for key in ("per_tensor_ms", "folded_bound_ms", "dense_bound_ms",
                    "batch1_ms", "batch1_bound_ms", "cuda_core_bound_ms",
                    "split_ms", "on_shared_planes_ms", "fp32_residual_ms",
                    "fp32_residual_bound_ms",
                    "fp32_residual_cuda_core_bound_ms",
                    "fp32_residual_plain_ms", "fp32_residual_library_ms",
                    "self_write_launches", "all_keys_bound_ms",
                    "oneshot_launches", "int8_self_launches",
                    "verify_launches", "draft_launches", "server_launches",
                    "server_verify_launches", "chain_bound_ms",
                    "serial_ms", "walk_bound_ms", "hard_inputs_ms",
                    "distill_launches", "daemon_launches",
                    "record_launches", "evaluate_launches",
                    "multichip_launches", "multichip_residual_launches",
                    "shapes", "int8_call_device_ms", "bf16_call_device_ms",
                    "int8_call_host_ms", "bf16_call_host_ms", "int8_xrt",
                    "bf16_xrt", *(
                        f"ctx{T}_{name}" for T in DAEMON_CTXS
                        for name in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")),
                    *(
                        "chunk5s_" + name for name in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "chain_bound_ms", "serial_ms",
                            "walk_bound_ms")), *(
                        pre + name for pre in ("oneshot_", "int8_",
                                               "oneshot_int8_", "t512_",
                                               "draft_bf16_")
                        for name in ("ms", "plain_ms", "bound_ms",
                                     "all_keys_bound_ms", "library_ms")), *(
                        pre + name for pre in ("", "g1_", "spec8_", "spec1_")
                        for name in ("per_query_ms", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms"))):
            if key in r:
                kernels[-1][key] = r[key]
        if "fp32_residual_ms" in r:
            kernels[-1]["fp32_residual_launches"] = launches[
                "flash_attention_lse"]
        if "split_ms" in r:
            kernels[-1]["split_launches"] = launches["split_planes"]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
