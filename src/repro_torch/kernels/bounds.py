"""The least time one H100 could take for each TPU kernel's work.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it must do over the card's peak rate for
the inputs' type.  Where the work depends on the data (valid ring slots,
distinct bank rows), the caller passes what the data needs.  Rates are the
H100 SXM data sheet's at its full 700 W power limit.

    python -m repro_torch.kernels.bounds     # table for every TPU kernel
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
SIZE = {"bfloat16": 2, "float32": 4}
F32 = 4


@dataclasses.dataclass(frozen=True)
class Bound:
    nbytes: int
    flops: int
    dtype: str

    @property
    def bytes_ms(self) -> float:
        return self.nbytes / HBM_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        return self.flops / PEAK_OPS_PER_S[self.dtype] * 1e3

    @property
    def ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def decode_attention(b: int, h: int, kh: int, hd: int, valid_slots: int,
                     dtype: str) -> Bound:
    """One query per (row, head) against ``valid_slots`` cached slots in
    total over the rows (per row: min(idx+1, ring), 0 for a masked row)."""
    s = SIZE[dtype]
    nbytes = 2 * b * h * hd * s + 2 * valid_slots * kh * hd * s + b * 4
    return Bound(nbytes, 4 * valid_slots * h * hd, dtype)


def grouped_gemv(b: int, k: int, n: int, r: int, users: int,
                 dtype: str) -> Bound:
    """y = x·W + s·x·A[g]·C[g]·B[g] for b rows of ``users`` distinct bank
    rows (f32 bank)."""
    s = SIZE[dtype]
    nbytes = (b * k * s + k * n * s + users * (k * r + r * r + r * n) * F32
              + b * 4 + b * n * s)
    return Bound(nbytes, 2 * b * k * n + 2 * b * (k * r + r * r + r * n),
                 dtype)


def tri_lora_matmul(m: int, k: int, n: int, r: int, dtype: str) -> Bound:
    """y = x@W + P@B with P (m, r) f32 computed outside the kernel."""
    s = SIZE[dtype]
    nbytes = m * k * s + k * n * s + m * r * F32 + r * n * s + m * n * s
    return Bound(nbytes, 2 * m * k * n + 2 * m * r * n, dtype)


def tri_lora_dx(m: int, k: int, n: int, r: int, dtype: str) -> Bound:
    """dx = g@Wᵀ + Q@Aᵀ with Q (m, r) f32 computed outside the kernel."""
    s = SIZE[dtype]
    nbytes = m * n * s + k * n * s + m * r * F32 + k * r * s + m * k * s
    return Bound(nbytes, 2 * m * n * k + 2 * m * r * k, dtype)


def tri_lora_dw(m: int, k: int, n: int, dtype: str) -> Bound:
    """dW = xᵀ@g."""
    s = SIZE[dtype]
    return Bound(m * k * s + m * n * s + k * n * s, 2 * m * k * n, dtype)


def _causal_pairs(sq: int) -> int:
    return sq * (sq + 1) // 2


def flash_fwd(b: int, h: int, kh: int, sq: int, hd: int,
              dtype: str) -> Bound:
    """Causal GQA forward with the f32 logsumexp output."""
    s = SIZE[dtype]
    nbytes = (2 * b * h * sq * hd * s + 2 * b * kh * sq * hd * s
              + b * h * sq * F32)
    return Bound(nbytes, 4 * b * h * _causal_pairs(sq) * hd, dtype)


def flash_bwd(b: int, h: int, kh: int, sq: int, hd: int,
              dtype: str) -> Bound:
    """dq, dk, dv from q, k, v, o, dO and the logsumexp: the scores and
    probabilities are recomputed (2 products) and three gradient products
    follow, 5 products of the forward's size in all."""
    s = SIZE[dtype]
    nbytes = (3 * b * h * sq * hd * s + 2 * b * kh * sq * hd * s
              + b * h * sq * F32 + b * h * sq * hd * s
              + 2 * b * kh * sq * hd * s)
    return Bound(nbytes, 10 * b * h * _causal_pairs(sq) * hd, dtype)


def flash_dq(b: int, h: int, kh: int, sq: int, hd: int,
             dtype: str) -> Bound:
    """dq alone from q, k, v, dO, lse and delta: scores and dO·vᵀ
    recomputed, then ds·k — 3 products of the forward's size."""
    s = SIZE[dtype]
    nbytes = (3 * b * h * sq * hd * s + 2 * b * kh * sq * hd * s
              + 2 * b * h * sq * F32)
    return Bound(nbytes, 6 * b * h * _causal_pairs(sq) * hd, dtype)


def flash_dkv(b: int, h: int, kh: int, sq: int, hd: int,
              dtype: str) -> Bound:
    """dk and dv from q, k, v, dO, lse and delta: scores and dO·vᵀ
    recomputed, then pᵀ·dO and dsᵀ·q — 4 products of the forward's size."""
    s = SIZE[dtype]
    nbytes = (2 * b * h * sq * hd * s + 4 * b * kh * sq * hd * s
              + 2 * b * h * sq * F32)
    return Bound(nbytes, 8 * b * h * _causal_pairs(sq) * hd, dtype)


def wkv6(b: int, h: int, t: int, hd: int, dtype: str) -> Bound:
    """The WKV6 recurrence as the model calls it: r, k, v (B,T,H,hd) and u
    (H,hd) in ``dtype``; w in f32 (the model's exp(-exp(ŵ)) of an f32 ŵ);
    y (B,T,H,hd) f32 out; the (B,H,hd,hd) f32 state read in and written
    out.  u is read once as (H,hd), not per batch row.  Per token and head
    the f32 state is decayed and updated (3·hd² ops) and read out (2·hd²
    ops); the state is carried in f32 whatever the inputs' type, so the
    operations count at the f32 rate."""
    n = b * h * t * hd
    nbytes = (3 * n * SIZE[dtype] + n * F32 + h * hd * SIZE[dtype]
              + n * F32 + 2 * b * h * hd * hd * F32)
    return Bound(nbytes, 5 * b * h * t * hd * hd, "float32")


#: Every TPU kernel of the repository at the shape its path uses: the
#: training path (fed-100m, f32, a batch of 8 sequences of 512 tokens,
#: rank 8, the wq projection), the serving path (LLaMA-7B width, bf16, 8
#: slots with full rings of 160, 8 users, rank 8), the rwkv6-1.6b prefill
#: (bf16, 8 sequences of 512 tokens, 32 heads of 64).
TABLE = (
    ("tri_lora_matmul_kernel", "src/repro/kernels/tri_lora/tri_lora.py:55",
     "fed-100m wq, M=4096 K=N=768 r=8, f32",
     tri_lora_matmul(4096, 768, 768, 8, "float32")),
    ("tri_lora_dx_kernel", "src/repro/kernels/tri_lora/tri_lora.py:107",
     "fed-100m wq, M=4096 K=N=768 r=8, f32",
     tri_lora_dx(4096, 768, 768, 8, "float32")),
    ("tri_lora_dw_kernel", "src/repro/kernels/tri_lora/tri_lora.py:154",
     "fed-100m wq, M=4096 K=N=768, f32",
     tri_lora_dw(4096, 768, 768, "float32")),
    ("flash_attention_kernel",
     "src/repro/kernels/flash_attention/flash_attention.py:124",
     "fed-100m, B=8 S=512 H=12 K=4 hd=64 causal, f32",
     flash_fwd(8, 12, 4, 512, 64, "float32")),
    ("flash_attention_bwd_kernel",
     "src/repro/kernels/flash_attention/flash_attention.py:255",
     "fed-100m, B=8 S=512 H=12 K=4 hd=64 causal, f32",
     flash_bwd(8, 12, 4, 512, 64, "float32")),
    ("decode_attention_kernel",
     "src/repro/kernels/decode_attention/decode_attention.py:57",
     "LLaMA-7B, B=8 H=K=32 hd=128, 8 full rings of 160, bf16",
     decode_attention(8, 32, 32, 128, 8 * 160, "bfloat16")),
    ("grouped_tri_lora_gemv_kernel",
     "src/repro/kernels/decode_attention/grouped.py:67",
     "LLaMA-7B wq, 8 rows of 8 users, K=N=4096 r=8, bf16",
     grouped_gemv(8, 4096, 4096, 8, 8, "bfloat16")),
    ("wkv6_kernel", "src/repro/kernels/rwkv6/rwkv6.py:79",
     "rwkv6-1.6b, B=8 H=32 T=512 hd=64, r/k/v/u bf16, w/y/state f32",
     wkv6(8, 32, 512, 64, "bfloat16")),
)


#: The tri-LoRA kernels at the shapes the training paths run (fed-100m, f32,
#: 8 sequences of 256 tokens, rank 8): wq/wo (K=N=768) and wk/wv (N=256).
TRAINING = tuple(
    row for proj, n in (("wq/wo", 768), ("wk/wv", 256))
    for row in (
        ("tri_lora_matmul_kernel", TABLE[0][1],
         f"fed-100m {proj}, M=2048 K=768 N={n} r=8, f32",
         tri_lora_matmul(2048, 768, n, 8, "float32")),
        ("tri_lora_dx_kernel", TABLE[1][1],
         f"fed-100m {proj}, M=2048 K=768 N={n} r=8, f32",
         tri_lora_dx(2048, 768, n, 8, "float32")),
        ("tri_lora_dw_kernel", TABLE[2][1],
         f"fed-100m {proj}, M=2048 K=768 N={n}, f32",
         tri_lora_dw(2048, 768, n, "float32"))))


#: The tri-LoRA forward at the shapes of the rwkv6-1.6b time mix (bf16,
#: d = 2048, rank 8): the prefill of 8 sequences of 512 tokens and a decode
#: step of 8 rows.
RWKV = tuple(
    ("tri_lora_matmul_kernel", TABLE[0][1],
     f"rwkv6-1.6b {phase}, M={m} K=N=2048 r=8, bf16",
     tri_lora_matmul(m, 2048, 2048, 8, "bfloat16"))
    for phase, m in (("prefill", 4096), ("decode", 8)))


def main() -> None:
    print("| kernel | TPU source | shape | MB moved | GFLOP | bound µs | "
          "bound by |")
    print("|---|---|---|---|---|---|---|")
    for name, src, shape, bd in TABLE + TRAINING + RWKV:
        print(f"| `{name}` | `{src}` | {shape} | {bd.nbytes / 1e6:.2f} | "
              f"{bd.flops / 1e9:.3f} | {bd.ms * 1e3:.2f} | {bd.by} |")


if __name__ == "__main__":
    main()
