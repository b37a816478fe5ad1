"""Times variants of the beam's per-step kernels on the card.

    python -m avsr_tpu_torch.tools.decode_variants [--dtype float32] base \\
        cols4=scan_logsumexp.cu:kCols=4 upto3=decode_attention.cu:stop=3 \\
        parent@build/parent/avsr_tpu_torch/csrc
    python -m avsr_tpu_torch.tools.decode_variants --sweep \\
        parent@build/parent/avsr_tpu_torch/csrc base again \\
        parent2@build/parent/avsr_tpu_torch/csrc

Each argument is a variant, read as ``flash_variants`` reads it: ``NAME``,
``NAME=FILE:CONST=VALUE[,...]`` (the named ``constexpr int`` of one of
SOURCES set to VALUE), or ``NAME@DIR`` with the sources of DIR, the
``csrc/`` of another checkout (say the parent commit's, unpacked with
``git archive``), whose wrappers ``DIR/../ops/kernels/{decode_attention,
scan_logsumexp}.py`` are then loaded beside them, so a C interface that
changed between the two still gets its own caller. All variants build at
once, one ``nvcc`` per source, under ``build/decode_variants/NAME/``; then
each runs in a process of its own, which loads its library and
``decode_attention`` and ``cumlogsumexp`` from its wrappers and:

- ``decode_attention`` at each of SHAPES (``chip_smoke.decode_case``, a
  bf16 cache at C=1024, 16 heads): beam 3 at pos 250 (the whole 192-row
  cache read) at B=8 and B=32, beam 22 at phase 8's shape at B=8 and B=32
  and over the serving cache at B=8; with ``--dtype float32`` at each of
  FP32_SHAPES instead (fp32 q and cache: the conformer decoder's C=768,
  12 heads at B=8 and B=32, the flagship's C=1024, 16 heads at B=8, and
  22 lanes at phase 8's shape): holds it against this checkout's twin
  (the cache bit-exact, out's max abs error and its largest ratio to
  ``output_bound``), then times it warm (one cache) and cold (rotating
  over six caches, as the six decoder layers read them), at every
  cluster size G of CLUSTERS where the wrapper has a launch plan (so this
  tool picks G; and, where the plan keeps two blocks an SM, the
  one-block-an-SM plan of the largest tile beside it), else as the
  wrapper launches it; the first variant, named ``base``, prints fused
  SDPA's time beside, and the bound (``chip_smoke.decode_bound``: with
  an fp32 cache at split TF32's three tf32 products a multiply-add);
- ``cumlogsumexp`` at (384, 96) and (384, 384) (``chip_smoke.scan_case``),
  against this checkout's twin, and timed.

With ``--sweep``, instead: ``decode_attention`` as each variant's wrapper
launches it by default, at each of SWEEP (a bf16 cache at C=1024, 16
heads, and an fp32 one at C=768, 12 heads; beam 3 at B=8 and B=32, and 22
lanes at B=8; a 192-row cache) and each step of SWEEP_POS, checked against
this checkout's twin and timed cold: the launch plan fixed at the cache's
S rows with the step read on the card (this checkout), or sized for the
step's rows (a parent whose wrapper takes the step as an int); the step
goes to a wrapper that reads it on the card as a tensor made once, so the
timed calls make no fill launch. Run the variants in the order parent,
change, change, parent to see the card's drift.

``decode_attention.cu:stop=N`` cuts the variant's copy of the decode
kernel short before its phase comment ``// N.`` (``cut``), so that the
phases are timed apart: stop=1 leaves the launch alone, stop=3 the copies
landed, 4 the scores and their statistics, 5 the cluster's softmax
statistics, 6 p and the warps' P.V, 7 the rank's partial. Such a variant's output is not the kernel's; its error is printed
all the same.

Times are ``chip_smoke.cuda_ms``; registers and spills of each kernel come
from its ``-Xptxas -v`` report. The wrapper's launch counters
(``launches``, ``wide_launches`` and, where it has one,
``tf32_launches``) are printed after each case's first call. Needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import re
import subprocess
import sys
from pathlib import Path

from avsr_tpu_torch.ops.kernels import _build
from avsr_tpu_torch.tools import flash_variants as fv

SOURCES = ("common.cuh", "philox.cuh", "mma_bf16.cuh", "mma_tf32.cuh",
           "runtime.cu", "decode_attention.cu", "scan_logsumexp.cu")
WRAPPERS = ("decode_attention", "scan_logsumexp")
CLUSTERS = (1, 2, 4, 8)
# (lanes, B, pos, cache rows) timed: beam 3 over the serving cache at B=8
# and B=32; beam 22 at phase 8's shape (S=128, pos 74) at B=8 and B=32,
# and over the serving cache at B=8
SHAPES = ((3, 8, 250, 192), (3, 32, 250, 192), (22, 8, 74, 128),
          (22, 32, 74, 128), (22, 8, 250, 192))
# (C, heads, lanes, B, pos, cache rows) timed with an fp32 cache: the
# conformer decoder's (the eval CLI's auto_avsr beam) at B=8 and B=32, the
# flagship's in fp32 at B=8, and 22 lanes at phase 8's shape
FP32_SHAPES = ((768, 12, 3, 8, 250, 192), (768, 12, 3, 32, 250, 192),
               (1024, 16, 3, 8, 250, 192), (1024, 16, 22, 8, 74, 128))
# --sweep: (dtype, C, heads, lanes, B) over a 192-row cache, at SWEEP_POS
SWEEP = tuple((dt, c, h, lanes, b)
              for dt, c, h in (("bfloat16", 1024, 16), ("float32", 768, 12))
              for lanes, b in ((3, 8), (3, 32), (22, 8)))
SWEEP_POS = (0, 95, 191, 250)
SWEEP_S = 192
ROOT = _build.PKG_DIR.parent
OUT = ROOT / "build" / "decode_variants"


def cut(text: str, phase: int) -> str:
    """The decode kernel's source with a return before its phase comment
    ``// N.``: before phase 1 at once (the launch alone), later once the
    block's copies landed and every block of the cluster arrived, so that
    no block leaves while another reads its shared memory."""
    marker = f"\n  // {phase}. "
    if text.count(marker) != 1:
        raise SystemExit(f"decode_attention.cu has no one phase {phase}")
    stop = ("\n  return;" if phase == 1 else
            "\n  cp_async_wait<0>();\n  cluster.sync();\n  return;")
    return text.replace(marker, stop + marker)


def prepare(name: str, where: Path, subs) -> Path:
    """Writes the variant's sources, the decode kernel cut short where a
    substitution says ``stop``, and, where ``where``'s checkout has them,
    its wrappers (``py/``); returns its directory."""
    stops = [int(v) for f, const, v in subs
             if (f, const) == ("decode_attention.cu", "stop")]
    out = fv.prepare(name, where, [x for x in subs if x[1] != "stop"],
                     SOURCES, OUT)
    for phase in stops:
        src = out / "csrc" / "decode_attention.cu"
        src.write_text(cut(src.read_text(), phase))
    kernels = where.parent / "ops" / "kernels"
    (out / "py").mkdir(exist_ok=True)
    for mod in WRAPPERS:
        if (kernels / f"{mod}.py").exists():
            (out / "py" / f"{mod}.py").write_text(
                (kernels / f"{mod}.py").read_text())
    return out


def wrapper(variant_dir: Path, mod: str):
    """The variant's wrapper module ``mod``, loaded from its ``py/`` copy
    (it imports this checkout's ``_build``, which ``fv.use`` pointed at
    the variant's library)."""
    path = variant_dir / "py" / f"{mod}.py"
    spec = importlib.util.spec_from_file_location(f"variant_{mod}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def demangle(entry: str) -> str:
    """The kernel's name and template arguments, where ``c++filt`` is
    there to read them."""
    try:
        name = subprocess.run(["c++filt", entry], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except OSError:
        return entry
    return re.sub(r"\(anonymous namespace\)::|\(.*$", "", name) or entry


def registers(log: str) -> list[str]:
    """Registers and spills of the decode and scan kernels from a
    ``-Xptxas -v`` report."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if (entry and re.search("decode_attention_kernel|cumlogsumexp_kernel",
                                entry)
                and ("registers" in line or "spill stores" in line)):
            out.append(f"{demangle(entry)}: "
                       + line.split(":", 1)[-1].strip())
    return out


def plans(pda, b, lanes, heads, kv_cap, pos, esize=2):
    """(label, plan) of each launch timed: as wrapped (a wrapper with no
    plans, or a parent's beyond its one-tile lanes), else every G of
    CLUSTERS with the wrapper's plan and, where it differs, the one-block-
    an-SM plan of the largest tile. The heads are 64 wide; ``esize``: the
    cache's bytes an element."""
    if not hasattr(pda, "launch_plan") or (
            lanes > pda.MAX_LANES and not hasattr(pda, "GROUP_LANES")):
        return [("launch as wrapped", None)]
    out = []
    for g in CLUSTERS:
        plan = (pda.launch_plan(b, lanes, heads, 64, kv_cap, pos, esize, g)
                if takes_pos(pda) else
                pda.launch_plan(b, lanes, heads, 64, kv_cap, esize, g))
        out.append((f"G={g} tile {plan.tile} chunk "
                    f"{getattr(plan, 'chunk', plan.rows_per_rank)} smem "
                    f"{plan.smem}", plan))
        if hasattr(pda, "_tiles") and plan.chunk == plan.rows_per_rank:
            big = pda._tiles(pda.SMEM_MAX, plan.group_lanes, 64, esize,
                             plan.rows_per_rank, 1)
            if big and big[0] != plan.tile:
                tile, chunk = big
                alt = plan._replace(tile=tile, chunk=chunk,
                                    smem=pda.smem_bytes(plan.group_lanes, 64,
                                                        esize, chunk, tile))
                out.append((f"G={g} tile {tile} chunk {chunk} smem "
                            f"{alt.smem} (one block an SM)", alt))
    return out


def takes_pos(pda) -> bool:
    """Whether the wrapper's launch plan is sized for the step (a parent's,
    which takes it as an int) rather than fixed at the cache's rows."""
    return "pos" in inspect.signature(pda.launch_plan).parameters


def step_arg(mod, pos: int, dev):
    """The step as a wrapper module takes it: one int32 on the card, made
    once, where its kernel reads the step there (this checkout's, through
    ``_build.device_step``), else the int (a parent's)."""
    import torch

    if "device_step" not in inspect.getsource(mod):
        return pos
    return torch.full((1,), pos, dtype=torch.int32, device=dev)


def sweep(name: str, pda, ref_da, cs, dev, g) -> None:
    """``--sweep``: each of SWEEP at each of SWEEP_POS as the wrapper
    launches it, against the twin, timed cold."""
    import torch

    for dt, c, heads, lanes, b in SWEEP:
        dtype = getattr(torch, dt)
        for pos in SWEEP_POS:
            q, kvs, row, lb = cs.decode_case(g, dev, b, pos,
                                             caches=cs.LAYERS, lanes=lanes,
                                             kv_cap=SWEEP_S, c=c, dtype=dtype)
            at = step_arg(pda, pos, dev)
            want, want_kv = ref_da.decode_attention_plain(
                pos, q, kvs[0].clone(), lb, lanes, heads, row)
            bnd = ref_da.output_bound(pos, q, kvs[0], lb, lanes, heads, row)
            kv = kvs[0].clone()
            got, _ = pda.decode_attention(at, q, kv, lb, lanes, heads, row)
            torch.cuda.synchronize()
            ratio = ((got.float() - want.float()).abs() / bnd).max().item()
            same = torch.equal(kv, want_kv)
            esize = q.element_size()
            plan = (pda.launch_plan(b, lanes, heads, 64, SWEEP_S, pos, esize)
                    if takes_pos(pda) else pda.launch_plan(
                        b, lanes, heads, 64, SWEEP_S, esize).at(pos))
            cold = cs.cuda_ms(cs.rotating(
                lambda kv: pda.decode_attention(at, q, kv, lb, lanes, heads,
                                                row), kvs))
            print(f"# [{name}] sweep {dt} C={c} H={heads} {lanes} lanes "
                  f"B={b} S={SWEEP_S} pos {pos}: cold {cold:.4f} ms (G="
                  f"{plan.cluster}, rows a rank {plan.rows_per_rank}, tile "
                  f"{plan.tile}, smem {plan.smem}; plan "
                  f"{'sized for the step' if takes_pos(pda) else 'fixed'}),"
                  f" {ratio:.3f} of output_bound, cache equal {same}",
                  flush=True)
            del q, kvs, row, lb, kv


def counts(pda) -> str:
    """The wrapper's launch counters, those it has."""
    fn = pda.decode_attention
    return ", ".join(f"{attr} {getattr(fn, attr)}"
                     for attr in ("launches", "wide_launches",
                                  "tf32_launches") if hasattr(fn, attr))


def run(name: str, dtype: str = "bfloat16", sweeping: bool = False) -> None:
    import torch

    cs = fv.chip_smoke()
    variant = OUT / name
    fv.use(variant)
    library, _ = _build.build()
    for line in registers(library.with_suffix(".log").read_text()):
        print(f"# [{name}] {line}")
    # each variant's kernels through its own wrappers, against this
    # checkout's twins
    from avsr_tpu_torch.ops.kernels import decode_attention as ref_da
    from avsr_tpu_torch.ops.kernels import scan_logsumexp as ref_sl

    pda = wrapper(variant, "decode_attention")
    psl = wrapper(variant, "scan_logsumexp")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    if sweeping:
        sweep(name, pda, ref_da, cs, dev, g)
        return
    takes_plan = "plan" in inspect.signature(pda._launch).parameters
    shapes = (FP32_SHAPES if dt == torch.float32 else
              [(1024, 16, *shape) for shape in SHAPES])
    for c, heads, lanes, b, pos, kv_cap in shapes:
        q, kvs, row, lb = cs.decode_case(g, dev, b, pos, caches=cs.LAYERS,
                                         lanes=lanes, kv_cap=kv_cap, c=c,
                                         dtype=dt)
        want, want_kv = ref_da.decode_attention_plain(
            pos, q, kvs[0].clone(), lb, lanes, heads, row)
        bnd = ref_da.output_bound(pos, q, kvs[0], lb, lanes, heads, row)
        where = f"{lanes} lanes C={c} H={heads} B={b} S={kv_cap} pos {pos}"
        at = step_arg(pda, pos, dev)
        for what, plan in plans(pda, b, lanes, heads, kv_cap, pos,
                                q.element_size()):
            def step(kv, plan=plan, q=q, row=row, lb=lb, heads=heads):
                if plan is None:
                    return pda.decode_attention(at, q, kv, lb, lanes, heads,
                                                row)
                if takes_plan:
                    return pda._launch(at, q, kv, lb, lanes, heads, row,
                                       plan=plan)
                # a parent's wrapper forces G alone
                return pda._launch(at, q, kv, lb, lanes, heads, row,
                                   plan.cluster)

            kv = kvs[0].clone()
            got, _ = step(kv)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ratio = (diff / bnd).max().item()
            same = torch.equal(kv, want_kv)
            launched = counts(pda)
            warm = cs.cuda_ms(lambda: step(kvs[0]))
            cold = cs.cuda_ms(cs.rotating(step, kvs))
            print(f"# [{name}] decode_attention {where} {what}: warm "
                  f"{warm:.4f} ms, cold {cold:.4f} ms, max_abs_err "
                  f"{err:.3e} ({ratio:.3f} of output_bound), cache equal "
                  f"{same}; counters after the first call: {launched}",
                  flush=True)
        if name == "base":
            ms, backend = cs.decode_sdpa_ms(q, kvs, lb, lanes, heads)
            bnd_ms, by = cs.decode_bound(
                q, kvs[0], lb, row, lanes, pos,
                "tf32" if dt == torch.float32 else "bf16")
            print(f"# [{name}] SDPA {where}: {ms:.4f} ms ({backend}); "
                  f"bound {bnd_ms:.6f} ms ({by})", flush=True)
        del q, kvs, row, lb
    for t, c in ((cs.T_PAD, 96), (cs.T_PAD, 384)):
        x = cs.scan_case(g, dev, t, c)
        got = psl.cumlogsumexp(x)
        want = ref_sl.cumlogsumexp_plain(x)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        err = (got - want).abs()[fin].max().item()
        inf_same = torch.equal(torch.isneginf(got), torch.isneginf(want))
        ms = cs.cuda_ms(lambda: psl.cumlogsumexp(x))
        print(f"# [{name}] cumlogsumexp ({t}, {c}): {ms:.4f} ms, "
              f"max_abs_err {err:.3e}, -inf equal {inf_same}", flush=True)


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--sweep", action="store_true")
    opts, rest = p.parse_known_args(argv)
    rc = fv.drive(rest, __spec__.name, SOURCES, prepare,
                  lambda name: run(name, opts.dtype, opts.sweep), OUT,
                  ("--dtype", opts.dtype) + (("--sweep",) if opts.sweep
                                             else ()))
    if rc == 2:
        print(__doc__)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
