"""FMA-chain and memory-stream rates of the card, in float32 and bfloat16
(port of tools/probe_bf16.py, kernel P1).

1. FMA-chain throughput: CHAINS independent accumulators per element,
   seeded x + k, each taking UNROLL / CHAINS + INNER - 1 steps
   a <- fma(a, c, d), then summed in chain order (csrc/probe_fma.cu; the
   twin `fma_chain_twin` computes the same chain in torch ops, each step
   rounded once as the card's fmaf and __hfma2 round it). Counted as the
   reference counts it: 2 * (UNROLL + (INNER - 1) * CHAINS) flops an
   element.
2. Memory stream: one multiply over 2^27 elements, read once and written
   once (a plain torch op, as the reference's jitted multiply is plain
   XLA), in float32 and bfloat16.

The reference's constants C and D move a float32 chain by about one ulp
a step, so a bit-equal check of the kernel against its twin sees a
single missing step on most lanes. In bfloat16 C rounds to 1 and D to
below half an ulp: the chain is the identity there. BF16_MOVE are
bfloat16 constants under which a step moves a chain by about one ulp,
for the kernel's bfloat16 check.

Run on the card: python3 -m fredholm_tpu_torch.tools.probe_bf16 [iters]
It prints each rate with the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .. import _build

UNROLL = 512   # fma steps an element, over all chains, before the loop tail
CHAINS = 8     # independent accumulator chains (hide the fma latency)
INNER = 8      # loop iterations: the tail adds (INNER - 1) steps a chain
C = 1.0000001
D = 1e-7
BF16_MOVE = (1.0 + 2.0 ** -7, 2.0 ** -10)  # a * (1 + 2^-7) moves a by 1-2 ulp
FLOPS_PER_ELEMENT = 2 * (UNROLL + (INNER - 1) * CHAINS)
STEPS = UNROLL // CHAINS + INNER - 1


def _constant(v: float, dtype) -> float:
    """v rounded to the element type, as the reference's jnp.asarray."""
    return float(torch.tensor(v, dtype=dtype))


def _round_odd_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded to float32 by round-to-odd: truncated toward zero,
    the last bit set when inexact."""
    f = x.to(torch.float32)
    back = f.double()
    inexact = back != x
    bits = f.view(torch.int32)
    bits = torch.where(inexact & (back.abs() > x.abs()), bits - 1, bits)
    return torch.where(inexact, bits | 1, bits).view(torch.float32)


def fma_rn(a: torch.Tensor, c: float, d: float) -> torch.Tensor:
    """a * c + d rounded once to a's type (float32 or bfloat16), as fmaf
    and __hfma2 round it; c and d are values of that type. The product is
    exact in float64; the sum is kept exact as a TwoSum pair (s, e) and
    rounded to odd at 53 bits (and, for bfloat16, again at 24 bits).
    Rounding to odd at p + 2 bits or more, then to nearest even at p bits,
    is one correct rounding to p bits."""
    p = a.double() * c
    s = p + d
    bp = s - p
    e = (p - (s - bp)) + (d - bp)
    bits = s.view(torch.int64)
    bits = torch.where((e != 0) & ((e < 0) != (s < 0)), bits - 1, bits)
    x = torch.where(e != 0, bits | 1, bits).view(torch.float64)
    if a.dtype == torch.float32:
        return x.to(torch.float32)
    return _round_odd_f32(x).to(a.dtype)


def fma_chain_twin(x: torch.Tensor, c: float = C, d: float = D,
                   steps: int = STEPS) -> torch.Tensor:
    """Plain PyTorch chain, bit for bit the kernel's: seeds x + k, `steps`
    fused multiply-adds a chain, each rounded once (fma_rn), then the sum
    in chain order, all in x's type."""
    _build.LAUNCHES["probe_fma_twin"] += 1
    c, d = _constant(c, x.dtype), _constant(d, x.dtype)
    accs = [x + k for k in range(CHAINS)]
    for _ in range(steps):
        accs = [fma_rn(a, c, d) for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma_inputs(rows: int, dtype, device, seed: int = 0) -> torch.Tensor:
    """[rows, 128] values uniform in [-2, 2) from `seed`, in dtype: the
    reference fills its input with 0.5; the rate does not depend on the
    values, and distinct ones let a check see every lane."""
    x = np.random.default_rng(seed).uniform(-2.0, 2.0, (rows, 128)).astype(np.float32)
    return torch.tensor(x, device=device).to(dtype)


def fma_chain(x: torch.Tensor, c: float = C, d: float = D) -> torch.Tensor:
    """The FMA chain of every element of x (float32 or bfloat16, [rows,
    128]) with constants c and d (rounded to x's type): the twin for a CPU
    tensor, else the kernel."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2 or x.shape[1] != 128 \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 or bfloat16 [rows, 128], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fma_chain_twin(x, c, d)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no probe kernel for device {x.device}")
    out = torch.empty_like(x)
    c, d = _constant(c, x.dtype), _constant(d, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().fh_probe_fma(x.data_ptr(), out.data_ptr(), x.numel(),
                                   int(x.dtype == torch.bfloat16), c, d, stream)
    _build.check(err, "probe_fma")
    _build.LAUNCHES["probe_fma"] += 1
    return out


def hbm_stream(y: torch.Tensor) -> torch.Tensor:
    """The reference's bandwidth probe: one multiply, read once, written once."""
    return y * 1.000001


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _best_ms(fn, x, iters: int, batch: int = 8) -> float:
    """Best of `iters` mean times of `batch` back-to-back calls (CUDA events)."""
    fn(x)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(batch):
            fn(x)
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / batch)
    return best


def check(x: torch.Tensor) -> list:
    """The kernel against its twin on x, bit for bit, with the reference's
    constants and, for bfloat16, with BF16_MOVE as well. Raises at a
    difference; returns the (c, d) pairs checked."""
    pairs = [(C, D)] + ([BF16_MOVE] if x.dtype == torch.bfloat16 else [])
    for c, d in pairs:
        got, want = fma_chain(x, c, d), fma_chain_twin(x, c, d)
        if not torch.equal(got, want):
            raise AssertionError(f"P1 {x.dtype} {tuple(x.shape)} (c={c}, d={d}): "
                                 f"{int((got != want).sum())} lanes differ from the twin")
    return pairs


def measure(iters: int = 5, fma_rows: int = 1 << 16, stream_elems: int = 1 << 27) -> dict:
    """The four rates on the card: FMA GFLOP/s (float32, bfloat16) over
    fma_inputs(fma_rows), memory-stream GB/s (read + write) over
    stream_elems elements. Returns {name: (ms, rate)}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA card; none is available")
    dev = torch.device("cuda")
    out = {}
    for name, dtype in (("fma f32", torch.float32), ("fma bf16", torch.bfloat16)):
        x = fma_inputs(fma_rows, dtype, dev)
        ms = _best_ms(fma_chain, x, iters)
        out[name] = (ms, x.numel() * FLOPS_PER_ELEMENT / (ms * 1e-3) / 1e9)
    yf = torch.full((stream_elems // 128, 128), 1.5, dtype=torch.float32, device=dev)
    for name, y in (("hbm stream f32", yf), ("hbm stream bf16", yf.to(torch.bfloat16))):
        ms = _best_ms(hbm_stream, y, iters)
        out[name] = (ms, y.numel() * y.element_size() * 2 / (ms * 1e-3) / 1e9)
    return out


def main() -> None:
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        pairs = check(fma_inputs(1 << 16, dtype, "cuda"))
        print(f"kernel bit-equal to its twin, {dtype} [65536, 128], (c, d) in {pairs}")
    for name, (ms, rate) in measure(iters).items():
        unit = "GFLOP/s" if name.startswith("fma") else "GB/s r+w"
        print(f"{name:16s}: {ms:8.4f} ms  {rate:10.1f} {unit}  ({card})", flush=True)


if __name__ == "__main__":
    main()
