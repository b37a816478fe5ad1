"""Times variants of the flash-attention kernels on the card.

    python -m avsr_tpu_torch.tools.flash_variants base \\
        fwd4=flash_attention.cu:kFwdMinBlocks=4 \\
        parent@build/parent/avsr_tpu_torch/csrc

Each argument is ``NAME`` or ``NAME=FILE:CONST=VALUE[,FILE:CONST=VALUE...]``:
a variant whose copy of the flash sources (``csrc/``) has each named
``constexpr int CONST = ...;`` set to VALUE; ``NAME@DIR`` takes the
sources from DIR instead, the ``csrc/`` of another checkout with the same
C interface (say the parent commit's, unpacked with ``git archive``), so
two versions compare within one call. All variants build at once,
one ``nvcc`` per source, under ``build/flash_variants/NAME/``; then each
runs in a process of its own, which loads its library and, at the
training shape (N = 6*16 heads, T=384, D=64, bf16, dropout 0.1) and the
serving shape (N = 8*16, no dropout), holds the forward, dq and dkv
against their plain twins (error relative to the largest entry, and the
share of elements equal bit for bit) and times them with
``chip_smoke.cuda_ms``; then the fp32 forward at the muavic encoder's
shape (N = 32*4, T=375) and the flagship eval's (N = 32*16, T=384), held
against the twin and timed beside fp32 SDPA with its bounds
(``chip_smoke.fp32_flash_record``), and the fp32 backward kernels at the
training shape with dropout 0.1 and the muavic shape without
(``chip_smoke.fp32_bwd_records``). The registers and spills of each flash
kernel come from its ``-Xptxas -v`` report. Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

from avsr_tpu_torch.ops.kernels import _build

SOURCES = ("common.cuh", "philox.cuh", "mma_bf16.cuh", "mma_tf32.cuh",
           "runtime.cu", "flash_attention.cu", "flash_attention_bwd.cu")
ROOT = _build.PKG_DIR.parent
OUT = ROOT / "build" / "flash_variants"


def parse(arg: str, sources=SOURCES):
    """(name, source dir, [(file, const, value), ...]) of one command-line
    variant; a substitution names one of ``sources``."""
    name, _, spec = arg.partition("=")
    name, _, where = name.partition("@")
    subs = []
    for item in filter(None, spec.split(",")):
        fname, _, assign = item.partition(":")
        const, _, value = assign.partition("=")
        if fname not in sources or not const or not value.isdigit():
            raise SystemExit(f"bad substitution {item!r} in {arg!r}")
        subs.append((fname, const, value))
    return name, Path(where) if where else _build.CSRC_DIR, subs


def prepare(name: str, where: Path, subs, sources=SOURCES,
            out: Path | None = None) -> Path:
    """Writes the variant's sources (those of ``sources`` that ``where``
    has) under ``out`` (default OUT); returns its directory."""
    out = OUT if out is None else out
    csrc = out / name / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for fname in sources:
        if not (where / fname).exists():
            continue
        text = (where / fname).read_text()
        for f, const, value in subs:
            if f == fname:
                text, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
                if n != 1:
                    raise SystemExit(f"{fname} has no one {const}")
        (csrc / fname).write_text(text)
    return out / name


def chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module: its timer, bounds and
    inputs."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def use(variant_dir: Path) -> None:
    """Points this process's kernel library at the variant's copy."""
    _build.CSRC_DIR = variant_dir / "csrc"
    _build.BUILD_DIR = variant_dir / "lib"


def registers(library: Path) -> list[str]:
    out, entry = [], None
    for line in library.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        k = entry and re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_"
                                r"(?:mma|tf32|simt))ILi(\d+)ELb(\d)", entry)
        if k and ("registers" in line or "spill stores" in line):
            out.append(f"{k.group(1)} D={k.group(2)} dropout={k.group(3)}: "
                       + line.split(":", 1)[-1].strip())
    return out


def run(name: str) -> None:
    import torch

    from avsr_tpu_torch.ops.kernels import flash_attention as pfa

    cs = chip_smoke()
    use(OUT / name)
    library, _ = _build.build()
    for line in registers(library):
        print(f"# [{name}] {line}")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    for b, rate in ((6, 0.1), (8, 0.0)):
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v, do, bias = cs._attention_inputs(g, dev, torch.bfloat16, b,
                                                 16, 384, 64)
        sc, seed = 0.125, ((20261016, 3) if rate else None)
        out, lse = pfa.flash_attention_fwd(q, k, v, bias, sc, rate, seed)
        dq, delta = pfa.flash_attention_bwd_dq(q, k, v, bias, out, do, lse,
                                               sc, rate, seed)
        dk, dv = pfa.flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta,
                                             sc, rate, seed)
        w_out, _ = pfa.flash_attention_plain(q, k, v, bias, sc,
                                             dropout_rate=rate,
                                             dropout_seed=seed)
        wants = pfa.flash_attention_bwd_plain(q, k, v, bias, out, do, lse,
                                              sc, dropout_rate=rate,
                                              dropout_seed=seed)
        torch.cuda.synchronize()
        errs = []
        for what, got, want in (("out", out, w_out), ("dq", dq, wants[0]),
                                ("dk", dk, wants[1]), ("dv", dv, wants[2])):
            rel = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            same = (got == want).float().mean().item()
            errs.append(f"{what} {rel:.2e}/{same:.5f}")
        ms = dict(
            fwd=cs.cuda_ms(lambda: pfa.flash_attention_fwd(
                q, k, v, bias, sc, rate, seed)),
            dq=cs.cuda_ms(lambda: pfa.flash_attention_bwd_dq(
                q, k, v, bias, out, do, lse, sc, rate, seed)),
            dkv=cs.cuda_ms(lambda: pfa.flash_attention_bwd_dkv(
                q, k, v, bias, do, lse, delta, sc, rate, seed)))
        print(f"# [{name}] B={b} rate={rate} error/bit-equal: "
              + ", ".join(errs))
        print(f"# [{name}] B={b} rate={rate} ms: "
              + ", ".join(f"{key} {val:.4f}" for key, val in ms.items()),
              flush=True)
    g = torch.Generator(device=dev).manual_seed(8)
    for b, heads, t in ((32, 4, 375), (32, 16, 384)):
        r = cs.fp32_flash_record(dev, g, b, heads, t)
        print(f"# [{name}] fp32 forward {r['shape']}: kernel {r['ms']:.4f} "
              f"ms, SDPA {r['library_ms']:.4f} ms, max_abs_err "
              f"{r['max_abs_err']:.3e}, lse {r['lse_err']:.3e}", flush=True)
    for b, heads, t, rate in ((6, 16, 384, 0.1), (32, 4, 375, 0.0)):
        for key, r in cs.fp32_bwd_records(dev, g, b, heads, t,
                                          rate).items():
            print(f"# [{name}] {key} {r['shape']}: kernel {r['ms']:.4f} ms, "
                  f"SDPA backward {r['library_ms']:.4f} ms, max_abs_err "
                  f"{r['max_abs_err']:.3e}", flush=True)


def drive(argv: list[str], module: str, sources, prepare_fn, run_fn,
          out: Path, flags: tuple = ()) -> int:
    """A variants tool's command line: with ``--build NAME`` or ``--run
    NAME`` one variant in this process; else every variant of ``argv``
    (read by ``parse`` against ``sources``, written by ``prepare_fn``)
    built at once, each in a process of its own, then each run in a
    process of its own (``python -m module --run NAME`` and the tool's
    own ``flags``, which calls ``run_fn``). Returns the exit code: 2
    without variants."""
    if len(argv) == 2 and argv[0] in ("--build", "--run"):
        if argv[0] == "--build":
            use(out / argv[1])
            _build.build()
        else:
            run_fn(argv[1])
        return 0
    variants = {name: (where, subs)
                for name, where, subs in (parse(a, sources) for a in argv)}
    if not variants:
        return 2
    for name, (where, subs) in variants.items():
        prepare_fn(name, where, subs)
    builds = {name: subprocess.Popen(
        [sys.executable, "-m", module, "--build", name], cwd=ROOT)
        for name in variants}
    rcs = {name: proc.wait() for name, proc in builds.items()}
    print(f"# builds (exit codes): {rcs}", flush=True)
    for name, rc in rcs.items():
        if rc == 0:
            subprocess.run([sys.executable, "-m", module, "--run", name,
                            *flags], cwd=ROOT, check=False)
    return 0 if all(rc == 0 for rc in rcs.values()) else 1


def main(argv: list[str]) -> int:
    rc = drive(argv, __spec__.name, SOURCES, prepare, run, OUT)
    if rc == 2:
        print(__doc__)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
