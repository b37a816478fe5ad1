"""Times variants of the beam's top-k (B5) and the stem tail's backward
pass 1 (B7 bwd1) on the card.

    python -m avsr_tpu_torch.tools.topk_stem_variants base \\
        t512=topk.cu:kThreads=512 r2=stem_fuse.cu:kStripRows=2 \\
        parent@build/parent/avsr_tpu_torch/csrc

Each argument is a variant, read as ``flash_variants`` reads it: ``NAME``,
``NAME=FILE:CONST=VALUE[,...]`` (the named ``constexpr int`` of one of
SOURCES set to VALUE), or ``NAME@DIR`` with the sources of DIR, the
``csrc/`` of another checkout (say the parent commit's, unpacked with
``git archive``), whose wrappers ``DIR/../ops/kernels/{topk,stem_fuse}.py``
(and ``row_gather.py``) are then loaded beside them. All variants build
at once, one ``nvcc`` per
source, under ``build/topk_stem_variants/NAME/``; then each runs in a
process of its own, which loads its library and its wrappers, prints the
two kernels' registers and spills (from the ``-Xptxas -v`` report), and:

- ``topk_lastdim`` at the beam's shapes (SHAPES: the pre-beam (B*3, 5049)
  k=4 and the flat (B, 15) k=3 at B=8 and B=32; beam 22's pre-beam
  (B*22, 5049) k=33 at B=8 and B=32, and k=48 and 64 at B=32), with ties
  at the row maximum: exact against this checkout's twin, timed beside
  ``torch.topk`` on the same tensor (warm: the beam's logits were just
  written) and beside the launch floor, a kernel that spins one cycle
  (``torch.cuda._sleep(1)``) timed the same way;
- the pre-beam with the CTC scorer's rows (GATHERS: beam 3 at B=8 and
  B=32, k=4, Tp=384; beam 22 at B=32, k=33, Tp=128): the pair the beam
  launched before, ``topk_lastdim``, the index add and ``row_gather``
  (``row_gather.py`` loaded beside the variant's ``topk.py``), timed, and
  where the variant's ``topk.py`` has it ``topk_gather_rows``, one launch,
  timed beside it, its ids and rows held bit for bit against the pair's
  and the pair's against this checkout's twins;
- ``bn_prelu_pool_bwd1`` at the training shape (N = 6*384 channels-last
  frames of (64, 44, 44), bf16; ``chip_smoke._stem_inputs``): dz and the
  three sums against this checkout's twin, a second call bit-equal to the
  first, and timed warm (the same inputs each call) and cold (rotating
  over two sets: 1.3 GB a call, which the 50 MB L2 cannot hold). The
  SHA-256 of dz's bytes goes to ``NAME/dz.sha256``; after the runs the
  tool prints whether each variant's dz is the first variant's bit for
  bit.

Times are ``chip_smoke.cuda_ms``. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import hashlib
import re
import sys
from pathlib import Path

from avsr_tpu_torch.ops.kernels import _build
from avsr_tpu_torch.tools import decode_variants as dv
from avsr_tpu_torch.tools import flash_variants as fv

SOURCES = ("common.cuh", "runtime.cu", "topk.cu", "stem_fuse.cu",
           "row_gather.cu")
WRAPPERS = ("topk", "stem_fuse", "row_gather")
SHAPES = ((24, 5049, 4), (96, 5049, 4), (8, 15, 3), (32, 15, 3),
          (176, 5049, 33), (704, 5049, 33), (704, 5049, 48),
          (704, 5049, 64))
# (B, beam, pre-beam k, the CTC table's Tp) of the pre-beam's row gather
GATHERS = ((8, 3, 4, 384), (32, 3, 4, 384), (32, 22, 33, 128))
KERNELS = r"topk\w*_kernel|bwd1_kernel"
ROOT = _build.PKG_DIR.parent
OUT = ROOT / "build" / "topk_stem_variants"


def prepare(name: str, where: Path, subs, sources=SOURCES,
            wrappers=WRAPPERS, out: Path | None = None) -> Path:
    """Writes the variant's sources (those of ``sources``) and, where
    ``where``'s checkout has them, its ``wrappers`` (``py/``) under ``out``
    (default OUT); returns its directory."""
    out = fv.prepare(name, where, subs, sources, OUT if out is None else out)
    kernels = where.parent / "ops" / "kernels"
    (out / "py").mkdir(exist_ok=True)
    for mod in wrappers:
        if (kernels / f"{mod}.py").exists():
            (out / "py" / f"{mod}.py").write_text(
                (kernels / f"{mod}.py").read_text())
    return out


def registers(log: str, kernels: str = KERNELS) -> list[str]:
    """Registers and spills of the kernels whose names match ``kernels``
    (default: the top-k and bwd1 kernels) from a ``-Xptxas -v`` report."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if (entry and re.search(kernels, entry)
                and ("registers" in line or "spill stores" in line)):
            out.append(f"{dv.demangle(entry)}: "
                       + line.split(":", 1)[-1].strip())
    return out


def same_digest(names, fname: str = "dz.sha256",
                out: Path | None = None) -> dict[str, bool]:
    """Whether each variant's digest ``fname`` (under ``out``, default OUT)
    is the first variant's; a variant that wrote none is False."""
    out = OUT if out is None else out
    digests = {}
    for name in names:
        path = out / name / fname
        digests[name] = path.read_text().strip() if path.exists() else None
    first = digests[names[0]]
    return {name: d is not None and d == first for name, d in digests.items()}


def topk_case(torch, g, dev, rows: int, v: int):
    """(rows, v) fp32 logits with each row's maximum repeated at columns
    v // 2 and v - 1 (ties the kernel breaks toward the lower index)."""
    x = torch.randn(rows, v, generator=g, device=dev)
    x[:, v // 2] = x.amax(dim=1)
    x[:, -1] = x.amax(dim=1)
    return x


def gather_case(torch, cs, name, ptk, prg, ref_tk, g, dev, b, lanes, k,
                tp):
    """Times the pre-beam top-k of (b, lanes, V) logits and its rows of a
    (b*V, tp) table: the unfused pair (top-k, index add, ``row_gather``)
    and, where ``ptk`` has it, ``topk_gather_rows``; prints both and
    whether their ids and rows agree bit for bit."""
    v = cs.VOCAB
    x = topk_case(torch, g, dev, b * lanes, v).view(b, lanes, v)
    table = torch.randn(b * v, tp, generator=g, device=dev)
    base = torch.arange(b, device=dev)[:, None, None] * v

    def pair():
        vals, ids = ptk.topk_lastdim(x, k)
        return vals, ids, prg.row_gather(table, (ids + base).view(-1))

    got = pair()
    want = ref_tk.topk_plain(x, k)
    torch.cuda.synchronize()
    exact = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
             and torch.equal(got[2], table[(want[1] + base).view(-1)]))
    ms = cs.cuda_ms(pair)
    bnd = cs.bound(cs.nbytes(x, *got, got[2]), k * x.numel(), "fp32")
    line = (f"# [{name}] pre-beam + rows B={b}, beam {lanes}, k={k}, "
            f"Tp={tp}: top-k + add + row_gather {ms:.4f} ms (exact "
            f"{exact})")
    if hasattr(ptk, "topk_gather_rows"):
        fused = ptk.topk_gather_rows(x, k, table)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(fused, got))
        fused_ms = cs.cuda_ms(lambda: ptk.topk_gather_rows(x, k, table))
        line += (f", topk_gather_rows {fused_ms:.4f} ms (the pair's bit "
                 f"for bit {same})")
    print(f"{line}; bound {bnd[0]:.6f} ms ({bnd[1]})", flush=True)


def run(name: str) -> None:
    import torch

    cs = fv.chip_smoke()
    variant = OUT / name
    fv.use(variant)
    library, _ = _build.build()
    for line in registers(library.with_suffix(".log").read_text()):
        print(f"# [{name}] {line}")
    from avsr_tpu_torch.ops.kernels import stem_fuse as ref_sf
    from avsr_tpu_torch.ops.kernels import topk as ref_tk

    ptk = dv.wrapper(variant, "topk")
    psf = dv.wrapper(variant, "stem_fuse")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(5)
    floor = cs.cuda_ms(lambda: torch.cuda._sleep(1))
    print(f"# [{name}] launch floor (a kernel that spins one cycle): "
          f"{floor:.4f} ms", flush=True)
    for rows, v, k in SHAPES:
        x = topk_case(torch, g, dev, rows, v)
        got = ptk.topk_lastdim(x, k)
        want = ref_tk.topk_plain(x, k)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        ms = cs.cuda_ms(lambda: ptk.topk_lastdim(x, k))
        lib = cs.cuda_ms(lambda: torch.topk(x, k))
        bnd = cs.bound(cs.nbytes(x, *got), k * x.numel(), "fp32")
        print(f"# [{name}] topk_lastdim ({rows}, {v}) k={k}: {ms:.4f} ms, "
              f"torch.topk {lib:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}), "
              f"exact {exact}", flush=True)

    prg = dv.wrapper(variant, "row_gather")
    for b, lanes, k, tp in GATHERS:
        gather_case(torch, cs, name, ptk, prg, ref_tk, g, dev, b, lanes, k,
                    tp)

    n = cs.TRAIN_BATCH * cs.T_PAD
    sets = []
    for _ in range(2):
        x, (scale, bias, alpha), dout = cs._stem_inputs(g, dev, n,
                                                        torch.bfloat16)
        mean, var = ref_sf._batch_stats_plain(x.float())
        rstd = torch.rsqrt(var + 1e-5)
        sets.append((x, ref_sf._pack(mean, rstd, scale, bias, alpha), dout))
    x, p, dout = sets[0]
    dz, red = psf.bn_prelu_pool_bwd1(x, p, dout)
    again = psf.bn_prelu_pool_bwd1(x, p, dout)
    mean, rstd, scale, bias, alpha = p
    w_dz, dgamma, dbeta, dalpha = ref_sf.bn_prelu_pool_bwd1_plain(
        x, scale, bias, alpha, mean, rstd, dout)
    torch.cuda.synchronize()
    same = torch.equal(again[0], dz) and torch.equal(again[1], red)
    dz_equal = (dz == w_dz).float().mean().item()
    sums = torch.stack([dbeta, dgamma, dalpha])
    red_err = ((red - sums).abs().max() / sums.abs().max()).item()
    (variant / "dz.sha256").write_text(hashlib.sha256(
        dz.permute(0, 2, 3, 1).contiguous().cpu().view(torch.uint8)
        .numpy().tobytes()).hexdigest())
    warm = cs.cuda_ms(lambda: psf.bn_prelu_pool_bwd1(x, p, dout))
    cold = cs.cuda_ms(cs.rotating(lambda s: psf.bn_prelu_pool_bwd1(*s),
                                  sets))
    bnd = cs.bound(cs.nbytes(x, dout, dz, red), 20 * x.numel(), "fp32")
    print(f"# [{name}] bn_prelu_pool_bwd1 N={n} bf16: warm {warm:.4f} ms, "
          f"cold {cold:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); dz "
          f"bit-equal to the twin's at {dz_equal:.6f} of its elements, sums "
          f"{red_err:.2e} of their largest; a second call bit-equal {same}",
          flush=True)


def main(argv: list[str]) -> int:
    rc = fv.drive(argv, __spec__.name, SOURCES, prepare, run, OUT)
    if rc == 2:
        print(__doc__)
        return rc
    if argv[0] not in ("--build", "--run") and len(argv) > 1:
        names = [fv.parse(a, SOURCES)[0] for a in argv]
        print(f"# dz bit-equal to [{names[0]}]'s: {same_digest(names)}")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
