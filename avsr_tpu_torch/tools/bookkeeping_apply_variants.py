"""Times variants of the beam's bookkeeping step (B8) and the stem tail's
apply pass (B7 apply) on the card.

    python -m avsr_tpu_torch.tools.bookkeeping_apply_variants base \\
        i2=beam_update.cu:kItems=2 r4=stem_fuse.cu:kStripRows=4 \\
        parent@build/parent/avsr_tpu_torch/csrc

Each argument is a variant, read as ``flash_variants`` reads it: ``NAME``,
``NAME=FILE:CONST=VALUE[,...]`` (the named ``constexpr int`` of one of
SOURCES set to VALUE), or ``NAME@DIR`` with the sources of DIR, the
``csrc/`` of another checkout (say the parent commit's, unpacked with
``git archive``), whose wrappers ``DIR/../ops/kernels/{beam_update,
stem_fuse}.py`` are then loaded beside them. All variants build at once,
one ``nvcc`` per source, under ``build/bookkeeping_apply_variants/NAME/``;
then each runs in a process of its own, which loads its library and its
wrappers, prints the registers and spills of the bookkeeping, apply and
bwd1 kernels (from the ``-Xptxas -v`` report), the launch floor (a kernel
that spins one cycle, ``torch.cuda._sleep(1)``, timed the same way), and:

- ``beam_update`` at B=8 and B=32 (``chip_smoke.step_state``: step 200,
  ties, a forced and a stopped lane): every output against this
  checkout's twin bit for bit, and timed; with
  ``beam_update.cu:kTrace=1`` also the phases of one launch (thread 0 of
  block (0, 0) marks each phase's end with the SM clock, scaled to ns by
  the global timer; the wide kernel's phases are WIDE_PHASES);
- ``beam_update`` beyond the warp kernel's limits (WIDE: beams of 10 and
  22, S'=15 and 33, at phase 8's B=32, L=98 and a 128-row ancestry, and
  beam 22 at B=8 over the serving L=377 and 192 rows; step 40, ties), the
  same way;
- ``bn_prelu_pool_apply`` at the training shape (N = 6*384 channels-last
  frames of (64, 44, 44), bf16) and the eval shape (N = 8*377), with
  the batch statistics as p: against this checkout's twin given the same
  p bit for bit, timed warm (the same inputs each call) and cold
  (rotating over two sets, which the 50 MB L2 cannot hold);
- ``bn_prelu_pool_bwd1`` at the training shape, warm, dz against the twin
  bit for bit (it shares the apply pass's strip walker).

The SHA-256 of each kernel's outputs goes to
``NAME/{b8,b8wide,apply,dz}.sha256``;
after the runs the tool prints whether each variant's outputs are the first
variant's bit for bit. Times are ``chip_smoke.cuda_ms``. Needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import sys
from pathlib import Path

from avsr_tpu_torch.ops.kernels import _build
from avsr_tpu_torch.tools import decode_variants as dv
from avsr_tpu_torch.tools import flash_variants as fv
from avsr_tpu_torch.tools import topk_stem_variants as tv

SOURCES = ("common.cuh", "runtime.cu", "beam_update.cu", "stem_fuse.cu")
WRAPPERS = ("beam_update", "stem_fuse")
KERNELS = r"beam_update\w*_kernel|apply_kernel|bwd1_kernel"
BATCHES = (8, 32)
# (B, K, S', encoder frames T (L = T + 2), ancestry rows) of the wide path
WIDE = ((32, 10, 15, 96, 128), (32, 22, 33, 96, 128), (8, 22, 33, 375, 192))
DIGESTS = ("b8.sha256", "b8wide.sha256", "apply.sha256", "dz.sha256")
# beam_update.cu's marks, where kTrace=1: the phases between them, in the
# warp kernel and in the wide kernel
PHASES = ("item loads issued", "candidates loaded", "k rounds",
          "bookkeeping", "barrier", "item stores")
WIDE_PHASES = ("copies and loads issued", "loads consumed, eos flags",
               "chunk rounds", "places", "bookkeeping", "tile wait, stores")
ROOT = _build.PKG_DIR.parent
OUT = ROOT / "build" / "bookkeeping_apply_variants"


def prepare(name: str, where: Path, subs) -> Path:
    return tv.prepare(name, where, subs, SOURCES, WRAPPERS, OUT)


def traced(variant: Path) -> bool:
    """Whether the variant's beam_update marks its phases (kTrace=1)."""
    src = (variant / "csrc" / "beam_update.cu").read_text()
    m = re.search(r"constexpr int kTrace = (\d+);", src)
    return bool(m and int(m.group(1)))


def read_marks():
    """The last launch's marks: (SM clocks, global-timer ns) of each."""
    import torch

    marks = torch.zeros(2, len(PHASES) + 1, dtype=torch.int64)
    fn = _build.function("avsr_beam_update_trace", (ctypes.c_void_p,))
    _build.check("avsr_beam_update_trace", fn(marks.data_ptr()))
    return marks.tolist()


def phase_ns(marks) -> list[float]:
    """Each phase's time in ns: its SM clocks scaled by the global timer's
    ns a clock over the whole launch."""
    clk, ns = marks
    scale = (ns[-1] - ns[0]) / max(clk[-1] - clk[0], 1)
    return [(b - a) * scale for a, b in zip(clk, clk[1:])]


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes in order (channels-last frames as
    they lie in memory)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        if t.dim() == 4:
            t = t.permute(0, 2, 3, 1)
        h.update(t.contiguous().cpu().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def run(name: str) -> None:
    import torch

    cs = fv.chip_smoke()
    variant = OUT / name
    fv.use(variant)
    library, _ = _build.build()
    for line in tv.registers(library.with_suffix(".log").read_text(),
                             KERNELS):
        print(f"# [{name}] {line}")
    from avsr_tpu_torch.ops.kernels import beam_update as ref_bu
    from avsr_tpu_torch.ops.kernels import stem_fuse as ref_sf

    pbu = dv.wrapper(variant, "beam_update")
    psf = dv.wrapper(variant, "stem_fuse")
    dev = torch.device("cuda:0")
    floor = cs.cuda_ms(lambda: torch.cuda._sleep(1))
    print(f"# [{name}] launch floor (a kernel that spins one cycle): "
          f"{floor:.4f} ms", flush=True)

    kw = cs.BEAM_UPDATE_KW
    outs = []
    for b in BATCHES:
        st = cs.step_state(5, 200, dev, True, b)
        at = dv.step_arg(pbu, 200, dev)
        got = pbu.beam_update(at, *st.values(), **kw)
        want = ref_bu.beam_update_plain(200, *st.values(), **kw)
        torch.cuda.synchronize()
        exact = all(torch.equal(got[k], w) for k, w in want.items())
        outs += list(got.values())
        ms = cs.cuda_ms(lambda: pbu.beam_update(at, *st.values(), **kw))
        bnd = cs.bound(cs.nbytes(*st.values(), *got.values()),
                       b * cs.BEAM * (cs.PRE_BEAM + 1) * (5 + cs.BEAM),
                       "fp32")
        print(f"# [{name}] beam_update B={b}: {ms:.4f} ms, bound "
              f"{bnd[0]:.6f} ms ({bnd[1]}), every output the twin's bit "
              f"for bit {exact}", flush=True)
        if traced(variant):
            print(f"# [{name}] beam_update B={b} phases (ns): "
                  + ", ".join(f"{what} {t:.0f}" for what, t in zip(
                      PHASES, phase_ns(read_marks()))), flush=True)
    (variant / DIGESTS[0]).write_text(digest(outs))
    outs = []
    for b, k, sp, t, rows in WIDE:
        st = cs.step_state(5, 40, dev, True, b, k, sp, t, rows)
        at = dv.step_arg(pbu, 40, dev)
        got = pbu.beam_update(at, *st.values(), **kw)
        want = ref_bu.beam_update_plain(40, *st.values(), **kw)
        torch.cuda.synchronize()
        exact = all(torch.equal(got[key], w) for key, w in want.items())
        outs += list(got.values())
        ms = cs.cuda_ms(lambda: pbu.beam_update(at, *st.values(), **kw))
        bnd = cs.bound(cs.nbytes(*st.values(), *got.values()),
                       b * k * (sp + 1) * (5 + k), "fp32")
        print(f"# [{name}] beam_update wide B={b}, K={k}, S'={sp}, "
              f"L={t + 2}: {ms:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}), "
              f"every output the twin's bit for bit {exact}", flush=True)
        if traced(variant):
            print(f"# [{name}] beam_update wide B={b}, K={k} phases (ns): "
                  + ", ".join(f"{what} {t:.0f}" for what, t in zip(
                      WIDE_PHASES, phase_ns(read_marks()))), flush=True)
    (variant / DIGESTS[1]).write_text(digest(outs))

    g = torch.Generator(device=dev).manual_seed(7)
    outs = []
    for n in (cs.TRAIN_BATCH * cs.T_PAD, cs.B * (cs.FRAMES + 2)):
        sets = []
        for _ in range(2):
            x, (scale, bias, alpha), dout = cs._stem_inputs(g, dev, n,
                                                            torch.bfloat16)
            mean, var = ref_sf._batch_stats_plain(x.float())
            sets.append((x, ref_sf._pack(mean, torch.rsqrt(var + 1e-5),
                                         scale, bias, alpha)))
        # the second set's x and p, and the twin given the same p
        out = psf.bn_prelu_pool_apply(x, sets[1][1])
        want = ref_sf.bn_prelu_pool_plain(x, scale, bias, alpha, train=False,
                                          running_mean=mean, running_var=var)
        torch.cuda.synchronize()
        exact = torch.equal(out, want)
        outs.append(out)
        del want
        warm = cs.cuda_ms(lambda: psf.bn_prelu_pool_apply(*sets[1]))
        cold = cs.cuda_ms(cs.rotating(lambda s: psf.bn_prelu_pool_apply(*s),
                                      sets))
        bnd = cs.bound(cs.nbytes(x, out), 4 * x.numel() + 8 * out.numel(),
                       "fp32")
        print(f"# [{name}] bn_prelu_pool_apply N={n} bf16: warm {warm:.4f} "
              f"ms, cold {cold:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"the twin's bit for bit (same p) {exact}", flush=True)
        if n == cs.TRAIN_BATCH * cs.T_PAD:
            dz, _ = psf.bn_prelu_pool_bwd1(*sets[1], dout)
            w_dz = ref_sf.bn_prelu_pool_bwd1_plain(
                x, scale, bias, alpha, mean, torch.rsqrt(var + 1e-5),
                dout)[0]
            torch.cuda.synchronize()
            (variant / DIGESTS[3]).write_text(digest([dz]))
            same = torch.equal(dz, w_dz)
            del dz, w_dz
            ms = cs.cuda_ms(lambda: psf.bn_prelu_pool_bwd1(*sets[1], dout))
            print(f"# [{name}] bn_prelu_pool_bwd1 N={n} bf16: warm {ms:.4f} "
                  f"ms; dz the twin's bit for bit {same}", flush=True)
        del sets, x, out, dout
    (variant / DIGESTS[2]).write_text(digest(outs))


def main(argv: list[str]) -> int:
    rc = fv.drive(argv, __spec__.name, SOURCES, prepare, run, OUT)
    if rc == 2:
        print(__doc__)
        return rc
    if argv[0] not in ("--build", "--run") and len(argv) > 1:
        names = [fv.parse(a, SOURCES)[0] for a in argv]
        for fname in DIGESTS:
            print(f"# {fname} equal to [{names[0]}]'s: "
                  f"{tv.same_digest(names, fname, OUT)}")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
