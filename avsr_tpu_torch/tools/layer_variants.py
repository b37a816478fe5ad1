"""Times variants of the one-launch decoder layer (B9) on the card.

    python -m avsr_tpu_torch.tools.layer_variants [--dtype float32] \\
        [--width 768] base upto3=decoder_layer.cu:stop=3 \\
        sub6=decoder_layer.cu:kTraceSub=6 \\
        parent@build/parent/avsr_tpu_torch/csrc

Each argument is a variant, read as ``flash_variants`` reads it: ``NAME``,
``NAME=FILE:CONST=VALUE[,...]`` (the named ``constexpr int`` of one of
SOURCES set to VALUE), or ``NAME@DIR`` with the sources of
DIR, the ``csrc/`` of another checkout (say the parent commit's, unpacked
with ``git archive``), whose wrappers ``DIR/../ops/kernels/decoder_layer.py``
and ``decode_attention.py`` (for the unfused step) are loaded beside
them, so a C interface that changed between the two still gets its own
caller. All variants build at once, one ``nvcc`` per
source, under ``build/layer_variants/NAME/``; then each runs in a process
of its own, which loads its library and its wrapper's
``decoder_layer_step``, prints the kernel's registers and spills (each
instantiation, from its ``-Xptxas -v`` report) and, at B=8 and B=32 (24
and 96 lanes; ``chip_smoke.layer_case``: F=3072, S=192, 377 source rows;
C=1024 with 16 heads, or with ``--width 768`` 12 heads, the conformer
decoder's; weights, caches and the unfused step in bf16, or in
``--dtype float32``) at pos 250:

- holds it against this checkout's twin (x_out and the written row
  relative to their largest entry; limit 2e-5 in fp32, 2e-2 in bf16, the
  card tests') and counts its launches a call;
- times it warm (one layer's weights and caches) and cold (rotating over
  six layers', which the 50 MB L2 cannot hold), and the unfused layer
  step (``TransformerDecoder.layer_step``) the same two ways, beside the
  kernel's bound (``chip_smoke.layer_bound``);
- where the wrapper takes a ``trace``, prints each phase's work and the
  grid sync after it (``phase_table``: medians over six cold calls of the
  kernel's per-block global-timer marks).

``decoder_layer.cu:stop=N`` cuts the variant's copy of the kernel short
before its phase comment ``// N.`` (``cut``), so that the phases are timed
apart: stop=1 leaves phase 0 (LN1), stop=2 adds the QKV
GEMV, 3 the self-attention, and so on to 10 (all but W2). Such a variant's
output is not the kernel's; its error is printed all the same. The trace
gives the same split in one build: ``decoder_layer.cu:kTraceSub=P``
also marks the steps of phase P (a GEMV's operand staged, products, sums
and epilogue, split-K, statistics; an attention's keys landed, scores,
softmax, P.V, output).

Times are ``chip_smoke.cuda_ms``. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import re
import sys
from pathlib import Path

from avsr_tpu_torch.ops.kernels import _build
from avsr_tpu_torch.tools import decode_variants as dv
from avsr_tpu_torch.tools import flash_variants as fv

# the layer kernel, and decode_attention for the unfused step it is timed
# against
SOURCES = ("common.cuh", "philox.cuh", "mma_bf16.cuh", "mma_tf32.cuh",
           "runtime.cu", "decoder_layer.cu", "decode_attention.cu")
WRAPPER = "decoder_layer.py"
ROOT = _build.PKG_DIR.parent
OUT = ROOT / "build" / "layer_variants"
HEADS = {1024: 16, 768: 12}  # the flagship's and the conformer's decoders
LIMITS = {"bfloat16": 2e-2, "float32": 2e-5}  # x_out and row vs the twin


def options(argv: list[str]):
    """(the case's dtype and width, the variants' arguments) of a command
    line: ``--dtype`` and ``--width`` anywhere, the rest for ``drive``."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--dtype", choices=sorted(LIMITS), default="bfloat16")
    p.add_argument("--width", type=int, choices=sorted(HEADS), default=1024)
    return p.parse_known_args(argv)


def cut(text: str, phase: int) -> str:
    """The layer kernel's source with a return before its phase comment
    ``// N.``: every block returns there, so none waits at a later grid
    sync."""
    marker = f"\n  // {phase}. "
    if text.count(marker) != 1:
        raise SystemExit(f"decoder_layer.cu has no one phase {phase}")
    return text.replace(marker, "\n  return;" + marker)


def prepare(name: str, where: Path, subs) -> Path:
    """Writes the variant's sources (the kernel cut short where a
    substitution says ``stop``) and its wrapper (``py/``) where
    ``where``'s checkout has one; returns its directory."""
    out = fv.prepare(name, where, [x for x in subs if x[1] != "stop"],
                     SOURCES, OUT)
    for f, const, value in subs:
        if (f, const) == ("decoder_layer.cu", "stop"):
            src = out / "csrc" / "decoder_layer.cu"
            src.write_text(cut(src.read_text(), int(value)))
    (out / "py").mkdir(exist_ok=True)
    for name in (WRAPPER, "decode_attention.py"):
        wrapper = where.parent / "ops" / "kernels" / name
        if wrapper.exists():
            (out / "py" / name).write_text(wrapper.read_text())
    return out


def registers(log: str) -> list[str]:
    """Registers and spills of each instantiation of the layer kernel."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if (entry and "decoder_layer_kernel" in entry
                and ("registers" in line or "spill stores" in line)):
            out.append(f"{dv.demangle(entry)}: "
                       + line.split(":", 1)[-1].strip())
    return out


def phase_times(marks, phases: int):
    """(work, barrier) in µs of each phase from one call's trace (a row of
    marks a block): work, the median over blocks of a phase's end minus its
    start; barrier, the grid sync after it, from the last block's arrival
    to the first block's start of the next phase."""
    import statistics

    blocks = [m for m in marks if m[0] > 0]
    out = []
    for p in range(phases):
        work = statistics.median(m[2 * p + 1] - m[2 * p] for m in blocks)
        barrier = (min(m[2 * p + 2] for m in blocks)
                   - max(m[2 * p + 1] for m in blocks)
                   if p + 1 < phases else 0)
        out.append((work / 1e3, barrier / 1e3))
    return out


def step_times(marks, phases: int, phase: int, steps: int):
    """The median over blocks (that marked them) of each step of ``phase``
    after the phase's start, in µs."""
    import statistics

    out = []
    for k in range(steps):
        got = [m[2 * phases + k] - m[2 * phase] for m in marks
               if m[0] > 0 and m[2 * phases + k] > 0]
        out.append(statistics.median(got) / 1e3 if got else None)
    return out


def trace_sub(source: Path) -> int:
    """The phase whose steps the layer kernel's source ``source`` traces
    (its ``kTraceSub``)."""
    m = re.search(r"constexpr int kTraceSub = (\d+);", source.read_text())
    if m is None:
        raise SystemExit(f"{source} has no kTraceSub")
    return int(m.group(1))


def phase_table(torch, step, mod, sub: int) -> str:
    """Each phase's work and the barrier after it (µs, medians over six
    cold calls, one a layer), from the kernel's global-timer trace; where
    the source marks the steps of phase ``sub`` (its kTraceSub), their
    times after the phase's start too."""
    import statistics

    dev = torch.device("cuda:0")
    runs, subs = [], []
    for i in range(6):
        trace = torch.zeros(4096, 2 * mod.PHASES + mod.STEPS,
                            dtype=torch.int64, device=dev)
        step(i, trace=trace)
        torch.cuda.synchronize()
        marks = trace.tolist()
        runs.append(phase_times(marks, mod.PHASES))
        if sub < mod.PHASES:
            subs.append(step_times(marks, mod.PHASES, sub, mod.STEPS))
    cells = []
    for p in range(mod.PHASES):
        work = statistics.median(r[p][0] for r in runs)
        barrier = statistics.median(r[p][1] for r in runs)
        cells.append(f"{p}: {work:.2f}+{barrier:.2f}")
    text = "phase work+barrier us: " + ", ".join(cells)
    if subs:
        steps = []
        for k in range(mod.STEPS):
            got = [r[k] for r in subs if r[k] is not None]
            steps.append("-" if not got else f"{statistics.median(got):.2f}")
        text += f"; phase {sub} steps at us: " + ", ".join(steps)
    return text


def run(name: str, dtype: str = "bfloat16", width: int = 1024) -> None:
    import torch

    cs = fv.chip_smoke()
    variant = OUT / name
    fv.use(variant)
    library, _ = _build.build()
    for line in registers(library.with_suffix(".log").read_text()):
        print(f"# [{name}] {line}")
    from avsr_tpu_torch.models.decoder import TransformerDecoder
    from avsr_tpu_torch.ops.kernels import decoder_layer as ref

    spec = importlib.util.spec_from_file_location(
        "variant_decoder_layer", variant / "py" / WRAPPER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the unfused step through the variant's own decode_attention wrapper,
    # whose C interface is its library's
    from avsr_tpu_torch.models import decoder as decoder_mod
    from avsr_tpu_torch.ops.kernels import decode_attention as da_mod

    if (variant / "py" / "decode_attention.py").exists():
        da_mod = dv.wrapper(variant, "decode_attention")
        decoder_mod.decode_attention = da_mod.decode_attention
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(4)
    lanes, heads, c, f, pos = cs.BEAM, HEADS[width], width, 3072, 250
    dt, lim = getattr(torch, dtype), LIMITS[dtype]
    print(f"# [{name}] C={c}, {heads} heads, F={f}, {dtype}, beam {lanes}, "
          f"S={cs.KV_CAP}, {cs.FRAMES + 2} source rows, pos {pos}",
          flush=True)
    for b in (cs.B, 32):
        case = cs.layer_case(g, dev, b, pos, layers=cs.LAYERS, c=c,
                             heads=heads, dtype=dt)
        scratch = mod.layer_scratch(b * lanes, c, f, dev)
        at = dv.step_arg(mod, pos, dev)

        def step(i, case=case, scratch=scratch, **kw):
            return mod.decoder_layer_step(
                at, case["x"], case["kvs"][i], *case["srcs"][i],
                case["mem_bias"], case["lb"], case["packs"][i], lanes, heads,
                scratch=scratch, **kw)

        # the twin reads the cache as it was before the kernel wrote the row
        want, want_kv = ref.decoder_layer_step_plain(
            pos, case["x"], case["kvs"][0].clone(), *case["srcs"][0],
            case["mem_bias"], case["lb"], case["packs"][0], lanes, heads)
        row = min(pos, cs.KV_CAP - 1)
        before = mod.decoder_layer_step.launches
        got, got_kv = step(0)
        launches = mod.decoder_layer_step.launches - before
        torch.cuda.synchronize()
        err = cs._rel_err(got, want)
        err_row = cs._rel_err(got_kv[:, row], want_kv[:, row])
        held = "within" if max(err, err_row) <= lim else "OVER"
        warm = cs.cuda_ms(lambda: step(0))
        cold = cs.cuda_ms(cs.rotating(step, range(cs.LAYERS)))
        dec = TransformerDecoder(cs.VOCAB, c, heads, f, layers=cs.LAYERS,
                                 cache_dtype=dtype, param_dtype=dtype).to(dev)
        for i, layer in enumerate(case["mods"]):
            dec.decoders[i].load_state_dict(layer.state_dict())
        cache = dec.init_cache(torch.randn(b, cs.FRAMES + 2, c, generator=g,
                                           device=dev), cs.KV_CAP, lanes)
        mask = (case["mem_bias"] == 0)[:, None, :]
        with torch.inference_mode():
            # this checkout's decoder and the variant's decode_attention:
            # the step as that wrapper takes it
            at_da = dv.step_arg(da_mod, pos, dev)

            def unfused(i, cache=cache, mask=mask, case=case):
                return dec.layer_step(i, case["x"], at_da, cache, mask,
                                      case["lb"], lanes)

            u_warm = cs.cuda_ms(lambda: unfused(0))
            u_cold = cs.cuda_ms(cs.rotating(unfused, range(cs.LAYERS)))
        bnd = cs.layer_bound(case, lanes,
                             "bf16" if dtype == "bfloat16" else "fp32")
        if hasattr(mod, "card_plan"):
            plan, smem = mod.card_plan(b * lanes, lanes, heads, c, f,
                                       cs.KV_CAP, cs.FRAMES + 2, dt, dt,
                                       dev.index)
            print(f"# [{name}] B={b}: grid {plan.grid}, {smem} B shared "
                  f"memory a block, item rows {plan.rows}, K slices "
                  f"{plan.slices}", flush=True)
        print(f"# [{name}] decoder_layer_step B={b}: warm {warm:.4f} ms, "
              f"cold {cold:.4f} ms, {launches} launch(es) a call, x_out "
              f"{err:.2e}, row {err_row:.2e} of their largest entry "
              f"({held} {lim:g}); unfused layer step warm {u_warm:.4f} ms, "
              f"cold {u_cold:.4f} ms; bound {bnd[0]:.6f} ms ({bnd[1]})",
              flush=True)
        if "trace" in inspect.signature(mod.decoder_layer_step).parameters:
            sub = trace_sub(variant / "csrc" / "decoder_layer.cu")
            print(f"# [{name}] B={b} "
                  + phase_table(torch, step, mod, sub), flush=True)
        del case, scratch, dec, cache


def main(argv: list[str]) -> int:
    opts, rest = options(argv)
    rc = fv.drive(rest, __spec__.name, SOURCES, prepare,
                  lambda name: run(name, opts.dtype, opts.width), OUT,
                  ("--dtype", opts.dtype, "--width", str(opts.width)))
    if rc == 2:
        print(__doc__)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
