"""How far ``decode_attention``'s outputs lie from its fp32 twin, and why.

    python -m avsr_tpu_torch.tools.decode_numerics [SEEDS]

The kernel and its fp32 twin (``decode_attention_plain``) on the card, the
twin on the CPU, and ``exact``, the same rounding points (q and p rounded
to the cache dtype, out to q's) evaluated in float64 in between, all on
the inputs of ``chip_smoke.decode_case``: the serving widths (K=3 lanes,
H=16, dh=64, S=192, a bf16 cache) at B=8 and B=32, pos 100, 191 and 250,
for seeds 0..SEEDS-1 (default 5). For each case it prints the max abs
difference of each pair, with bf16 outputs (q in bf16, as the beam serves)
and before the output's rounding (the same q given in fp32, which every
evaluation rounds to bf16 as it does the bf16 q), the count of bf16
outputs more than 1e-3 apart and how many of those are one bf16 ulp
apart, and whether the kernel's bf16 output is its fp32 output rounded.
Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import sys

import torch

from avsr_tpu_torch.ops.kernels import _build
from avsr_tpu_torch.ops.kernels import decode_attention as pda

LANES, HEADS = 3, 16


def exact(pos: int, q, kv_cache, lane_bias, lanes: int, heads: int, kv_row):
    """``decode_attention_plain``'s rounding points, float64 in between
    (each narrowing cast goes through fp32, as the kernel's values do)."""
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    b, dh = n // lanes, c // heads
    kv_cache = kv_cache.clone()
    kv_cache[:, min(pos, s_max - 1)] = kv_row.to(kv_cache.dtype)
    kv = kv_cache.view(b, lanes, s_max, 2, heads, dh).double()
    qq = q.to(kv_cache.dtype).double().view(b, lanes, heads, dh)
    scores = torch.einsum("bkhd,bjshd->bhkjs", qq, kv[:, :, :, 0])
    scores = scores + lane_bias.permute(0, 1, 3, 2)[:, None].double()
    flat = scores.reshape(b, heads, lanes, lanes * s_max)
    p = torch.exp(flat - flat.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p.float().to(kv_cache.dtype).double()
    out = torch.einsum("bhkjs,bjshd->bkhd",
                       p.view(b, heads, lanes, lanes, s_max), kv[:, :, :, 1])
    return out.reshape(n, c).float().to(q.dtype)


def apart(a, b) -> str:
    """Max abs difference; for bf16, the count more than 1e-3 apart and
    of those the count one ulp apart (adjacent bit patterns)."""
    diff = (a.float() - b.float()).abs()
    text = f"{diff.max().item():.3e}"
    if a.dtype == torch.bfloat16:
        over = diff > 1e-3
        steps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
        one = (over & (steps == 1) & ((a > 0) == (b > 0))).sum().item()
        text += f" ({over.sum().item()} > 1e-3, {one} of them one ulp)"
    return text


def main(argv: list[str]) -> int:
    seeds = int(argv[0]) if argv else 5
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _build.PKG_DIR.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in range(seeds):
        g = torch.Generator(device=dev).manual_seed(seed)
        for b in (8, 32):
            for pos in (100, 191, 250):
                q, (kv,), row, lb = cs.decode_case(g, dev, b, pos)
                args = (lb, LANES, HEADS, row)
                res = {}
                for name, qq in (("bf16", q), ("fp32", q.float())):
                    res[name] = dict(
                        kernel=pda.decode_attention(pos, qq, kv.clone(),
                                                    *args)[0],
                        twin=pda.decode_attention_plain(pos, qq, kv.clone(),
                                                        *args)[0],
                        exact=exact(pos, qq, kv, *args),
                        cpu=pda.decode_attention_plain(
                            pos, qq.cpu(), kv.cpu(), lb.cpu(), LANES, HEADS,
                            row.cpu())[0].to(dev))
                torch.cuda.synchronize()
                rounded = torch.equal(res["bf16"]["kernel"],
                                      res["fp32"]["kernel"].to(torch.bfloat16))
                big = (res["bf16"]["twin"].float().abs() >= 0.25).float()
                print(f"# seed {seed} B={b} pos {pos}: |out| >= 0.25 at "
                      f"{big.mean().item():.4f} of outputs; kernel bf16 = "
                      f"its fp32 rounded: {rounded}")
                for name, r in res.items():
                    print(f"#   {name}: kernel-twin "
                          f"{apart(r['kernel'], r['twin'])}; kernel-exact "
                          f"{apart(r['kernel'], r['exact'])}; twin-exact "
                          f"{apart(r['twin'], r['exact'])}; twin cpu-card "
                          f"{apart(r['cpu'], r['twin'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
