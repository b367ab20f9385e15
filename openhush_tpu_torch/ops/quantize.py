"""Per-(row, head) int8 quantization on the hand-written CUDA kernel
(csrc/quantize_heads.cu).

Counterpart of openhush_tpu/ops/quantize_pallas.py and of the XLA branch of
openhush_tpu/models/whisper/model.py:_quantize_heads, whose arithmetic
`quantize_heads_plain` copies step for step.
"""

from __future__ import annotations

import torch

from openhush_tpu_torch.ops import _build

MAX_HEAD_DIM = 128     # four values per lane of the kernel's warp
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INV127 = 1.0 / 127.0


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


def quantize_heads(x: torch.Tensor, n_head: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same function as `quantize_heads_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return quantize_heads_plain(x, n_head)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_heads: unsupported device {x.device}")
    B, T, HD = x.shape
    if x.dtype not in _DTYPES or HD % n_head or HD // n_head > MAX_HEAD_DIM:
        raise ValueError(f"quantize_heads: {x.dtype} [.., {HD}] with "
                         f"{n_head} heads; the kernel takes fp32 or bf16 "
                         f"and head_dim <= {MAX_HEAD_DIM}")
    x = x.contiguous()
    q = torch.empty(B, T, HD, dtype=torch.int8, device=x.device)
    s = torch.empty(B, T, n_head, dtype=torch.float32, device=x.device)
    err = _build.library().oh_quantize_heads(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), B * T * n_head,
        HD // n_head, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "oh_quantize_heads")
    quantize_heads.launches += 1
    return q, s


quantize_heads.launches = 0
