"""Per-(row, head) int8 quantization on the hand-written CUDA kernel
(csrc/quantize_heads.cu).

Counterpart of openhush_tpu/ops/quantize_pallas.py and of the XLA branch of
openhush_tpu/models/whisper/model.py:_quantize_heads, whose arithmetic
`quantize_heads_plain` copies step for step. `quantize_heads_kv` quantizes
a layer's cross-attention K and V in one launch, into slices of buffers the
caller holds (the stacked int8 cross-KV cache).
"""

from __future__ import annotations

import torch

from openhush_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INV127 = 1.0 / 127.0
# A (row, head) group is 16 bytes a lane over at most a warp's lanes:
# head_dim * element size a multiple of 16 bytes, at most 512 (bf16: head_dim
# a multiple of 8 up to 256; fp32: a multiple of 4 up to 128).
_MAX_GROUP_BYTES = 512


def quantize_heads_plain(x: torch.Tensor, n_head: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, H*D] → (int8 [B, T, H*D], fp32 scales [B, T, H]).
    scale = max|x_h| * (1/127) is a reciprocal multiply (in fp32, as the
    reference rounds it), q = round-half-even(x / max(scale, 1e-10))."""
    B, T, HD = x.shape
    x32 = x.float().reshape(B, T, n_head, HD // n_head)
    scale = x32.abs().amax(dim=-1) * torch.tensor(_INV127, dtype=torch.float32)
    safe = torch.clamp(scale, min=1e-10)
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return q.to(torch.int8).reshape(B, T, HD), safe


def quantize_heads_kv_plain(k: torch.Tensor, v: torch.Tensor, n_head: int,
                            out: tuple[torch.Tensor, ...]) -> None:
    """`quantize_heads_plain` of k and of v, written into
    out = (k int8, k scales, v int8, v scales)."""
    for x, q, s in ((k, *out[:2]), (v, *out[2:])):
        qx, sx = quantize_heads_plain(x, n_head)
        q.copy_(qx)
        s.copy_(sx)


def _check(name: str, xs, outs, n_head: int) -> None:
    """Raise on what the kernel does not take: its device, dtypes, shapes,
    contiguity and alignment."""
    x = xs[0]
    B, T, HD = x.shape
    group = HD // n_head * x.element_size()
    if (x.dtype not in _DTYPES or HD % n_head or group % 16
            or group > _MAX_GROUP_BYTES):
        raise ValueError(f"{name}: {x.dtype} [.., {HD}] with {n_head} heads; "
                         f"the kernel takes fp32 or bf16 with head_dim * "
                         f"element size a multiple of 16 bytes, at most "
                         f"{_MAX_GROUP_BYTES}")
    store = 16 // x.element_size()
    for t in xs:
        if (t.shape != x.shape or t.dtype != x.dtype
                or t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"{name}: inputs must share shape, dtype and "
                             f"device, each 16-byte aligned")
    for q, s in zip(outs[::2], outs[1::2]):
        if (q.dtype != torch.int8 or q.shape != (B, T, HD)
                or s.dtype != torch.float32 or s.shape != (B, T, n_head)
                or not (q.is_contiguous() and s.is_contiguous())
                or q.device != x.device or s.device != x.device
                or q.data_ptr() % store or s.data_ptr() % 4):
            raise ValueError(f"{name}: outputs must be contiguous int8 "
                             f"[{B}, {T}, {HD}] ({store}-byte aligned) and "
                             f"fp32 [{B}, {T}, {n_head}] on {x.device}")


def _launch(k: torch.Tensor, v: torch.Tensor | None, outs, n_head: int
            ) -> None:
    """One launch for k, and for v unless it is None; outs = (k int8, k
    scales[, v int8, v scales])."""
    B, T, HD = k.shape
    err = _build.library().oh_quantize_heads_kv(
        k.data_ptr(), None if v is None else v.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(),
        None if v is None else outs[2].data_ptr(),
        None if v is None else outs[3].data_ptr(), B * T * n_head,
        HD // n_head, _DTYPES[k.dtype],
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(err, "oh_quantize_heads_kv")


def quantize_heads(x: torch.Tensor, n_head: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same function as `quantize_heads_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return quantize_heads_plain(x, n_head)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_heads: unsupported device {x.device}")
    x = x.contiguous()
    B, T, HD = x.shape
    q = torch.empty(B, T, HD, dtype=torch.int8, device=x.device)
    s = torch.empty(B, T, n_head, dtype=torch.float32, device=x.device)
    _check("quantize_heads", (x,), (q, s), n_head)
    _launch(x, None, (q, s), n_head)
    quantize_heads.launches += 1
    return q, s


def quantize_heads_kv(k: torch.Tensor, v: torch.Tensor, n_head: int,
                      out: tuple[torch.Tensor, ...]) -> None:
    """`quantize_heads` of k and of v [B, T, H*D], written into
    out = (k int8 [B, T, H*D], k scales [B, T, H], v int8, v scales):
    contiguous tensors, for example slice l of the stacked cross-KV cache.
    CPU tensors take the plain version; CUDA tensors launch the kernel once
    for both."""
    if k.device.type == "cpu":
        return quantize_heads_kv_plain(k, v, n_head, out)
    if k.device.type != "cuda":
        raise ValueError(f"quantize_heads_kv: unsupported device {k.device}")
    k, v = k.contiguous(), v.contiguous()
    _check("quantize_heads_kv", (k, v), out, n_head)
    _launch(k, v, out, n_head)
    quantize_heads_kv.launches += 1


quantize_heads.launches = 0
quantize_heads_kv.launches = 0
