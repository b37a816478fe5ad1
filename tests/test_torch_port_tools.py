"""The port's tools on the CPU: how the kernel-variant tools read
variants and write their sources (building and timing them needs the
card); the trace parser on synthetic traces, against the JAX package's
``tools/profile_train.parse_trace``; the card-only tools' refusal without
a card; ``dryrun.entry`` against the JAX model's loss, the multi-process
dry run, and ``bench_data`` at a tiny config."""

import gzip
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from avsr_tpu_torch.tools import flash_variants as fv


def test_variant_arguments_parse():
    assert fv.parse("base") == ("base", fv._build.CSRC_DIR, [])
    assert fv.parse("old@some/csrc") == ("old", Path("some/csrc"), [])
    name, where, subs = fv.parse("mb2=flash_attention.cu:kFwdMinBlocks=2,"
                                 "flash_attention_bwd.cu:kDqMinBlocks=2")
    assert (name, where) == ("mb2", fv._build.CSRC_DIR)
    assert subs == [("flash_attention.cu", "kFwdMinBlocks", "2"),
                    ("flash_attention_bwd.cu", "kDqMinBlocks", "2")]
    for bad in ("x=nosuch.cu:kFwdMinBlocks=2", "x=flash_attention.cu:k=a",
                "x=flash_attention.cu:kFwdMinBlocks"):
        with pytest.raises(SystemExit):
            fv.parse(bad)


@pytest.mark.parametrize("fname,const", [
    ("flash_attention.cu", "kFwdMinBlocks"),
    ("flash_attention.cu", "kKeysMma"),
    ("flash_attention_bwd.cu", "kDqMinBlocks"),
    ("flash_attention_bwd.cu", "kDkvMinBlocks"),
    ("flash_attention_bwd.cu", "kDkvCols"),
])
def test_variant_sources_change_one_constant(tmp_path, monkeypatch, fname,
                                             const):
    """A variant's copy of the sources differs from the originals only in
    the named constant's value; a constant that is not there is refused."""
    monkeypatch.setattr(fv, "OUT", tmp_path)
    out = fv.prepare("v", fv._build.CSRC_DIR, [(fname, const, "7")])
    for src in fv.SOURCES:
        orig = (fv._build.CSRC_DIR / src).read_text()
        copy = (out / "csrc" / src).read_text()
        if src != fname:
            assert copy == orig
            continue
        assert re.search(rf"constexpr int {const} = 7;", copy)
        assert re.sub(rf"(constexpr int {const} = )\d+;", r"\g<1>7;",
                      orig) == copy
    with pytest.raises(SystemExit):
        fv.prepare("w", fv._build.CSRC_DIR, [(fname, "kNoSuchConstant",
                                              "1")])


def test_variant_sources_from_another_checkout(tmp_path, monkeypatch):
    """``NAME@DIR`` copies the sources DIR has, unchanged."""
    monkeypatch.setattr(fv, "OUT", tmp_path / "out")
    old = tmp_path / "old"
    old.mkdir()
    (old / "flash_attention.cu").write_text("// another version\n")
    out = fv.prepare("parent", old, [])
    assert sorted(p.name for p in (out / "csrc").iterdir()) == [
        "flash_attention.cu"]
    assert (out / "csrc" / "flash_attention.cu").read_text() == (
        "// another version\n")


# ------------------------------------------------- decode_variants


def test_decode_variant_arguments_name_its_sources():
    """decode_variants substitutes in the decode and scan sources only."""
    from avsr_tpu_torch.tools import decode_variants as dv

    name, where, subs = fv.parse("v=decode_attention.cu:stop=3,"
                                 "scan_logsumexp.cu:kCols=16", dv.SOURCES)
    assert (name, where) == ("v", fv._build.CSRC_DIR)
    assert subs == [("decode_attention.cu", "stop", "3"),
                    ("scan_logsumexp.cu", "kCols", "16")]
    with pytest.raises(SystemExit):
        fv.parse("x=flash_attention.cu:kFwdMinBlocks=2", dv.SOURCES)


@pytest.mark.parametrize("fname,const", [
    ("decode_attention.cu", "kTileLanes"),
    ("decode_attention.cu", "kThreads"),
    ("scan_logsumexp.cu", "kCols"),
    ("scan_logsumexp.cu", "kLaneRows"),
])
def test_decode_variant_sources_and_wrappers(tmp_path, monkeypatch, fname,
                                             const):
    """A variant of this checkout changes one constant of its copy and
    carries this checkout's two wrappers; one of another checkout carries
    that checkout's sources and wrappers, so each version is called
    through its own C interface."""
    from avsr_tpu_torch.tools import decode_variants as dv

    monkeypatch.setattr(dv, "OUT", tmp_path / "out")
    out = dv.prepare("v", fv._build.CSRC_DIR, [(fname, const, "4")])
    copy = (out / "csrc" / fname).read_text()
    assert re.search(rf"constexpr int {const} = 4;", copy)
    for mod in dv.WRAPPERS:
        pkg = fv._build.PKG_DIR / "ops" / "kernels" / f"{mod}.py"
        assert (out / "py" / f"{mod}.py").read_text() == pkg.read_text()
    assert dv.wrapper(out, "decode_attention").launch_plan(
        8, 3, 16, 64, 192, 2).cluster == 2

    old = tmp_path / "parent" / "avsr_tpu_torch"
    (old / "csrc").mkdir(parents=True)
    (old / "ops" / "kernels").mkdir(parents=True)
    (old / "csrc" / "decode_attention.cu").write_text("// old kernel\n")
    (old / "ops" / "kernels" / "decode_attention.py").write_text("X = 1\n")
    out = dv.prepare("parent", old / "csrc", [])
    assert sorted(p.name for p in (out / "csrc").iterdir()) == [
        "decode_attention.cu"]
    assert sorted(p.name for p in (out / "py").iterdir()) == [
        "decode_attention.py"]
    assert dv.wrapper(out, "decode_attention").X == 1


@pytest.mark.parametrize("phase", [1, 3, 4, 5, 6, 7])
def test_decode_variant_cuts_the_kernel_short(tmp_path, monkeypatch, phase):
    """``stop=N`` returns before the decode kernel's phase comment N in the
    variant's copy only: at once before phase 1, else after the copies
    land and the cluster's blocks meet; the shipped source has no early
    return, and a phase the source lacks is refused."""
    from avsr_tpu_torch.tools import decode_variants as dv

    monkeypatch.setattr(dv, "OUT", tmp_path / "out")
    src = (fv._build.CSRC_DIR / "decode_attention.cu").read_text()
    out = dv.prepare("v", fv._build.CSRC_DIR,
                     [("decode_attention.cu", "stop", str(phase))])
    copy = (out / "csrc" / "decode_attention.cu").read_text()
    marker = f"\n  // {phase}. "
    stop = ("\n  return;" if phase == 1 else
            "\n  cp_async_wait<0>();\n  cluster.sync();\n  return;")
    assert copy.count(stop + marker) == 1
    assert copy.replace(stop + marker, marker) == src
    assert "\n  return;" not in src
    with pytest.raises(SystemExit):
        dv.cut(src, 9)


def test_decode_variant_register_report():
    """Registers and spills of the decode and scan kernels, and of no other,
    are read from a ptxas report."""
    from avsr_tpu_torch.tools import decode_variants as dv

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_123decode_attention_kernelIffLi4EEEvPKT_' for "
        "'sm_90a'",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_Z12topk_kernelPKf' for "
        "'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119cumlogsumexp_kernelEPKfPfii' for 'sm_90a'",
        "ptxas info    : Used 77 registers, used 1 barriers, 13440 bytes smem",
    ])
    lines = dv.registers(log)
    assert len(lines) == 3
    assert "decode_attention_kernel" in lines[0] and "64 registers" in lines[0]
    assert "spill stores" in lines[1]
    assert "cumlogsumexp_kernel" in lines[2] and "77 registers" in lines[2]


# ------------------------------------------------- layer_variants


@pytest.mark.parametrize("phase", range(1, 11))
def test_layer_variant_cuts_the_kernel_short(tmp_path, monkeypatch, phase):
    """``decoder_layer.cu:stop=N`` returns before the layer kernel's phase
    comment N in the variant's copy only (every block, so no block waits at
    a later grid sync); the shipped source has no such return; a phase the
    source lacks is refused."""
    from avsr_tpu_torch.tools import layer_variants as lv

    monkeypatch.setattr(lv, "OUT", tmp_path / "out")
    src = (fv._build.CSRC_DIR / "decoder_layer.cu").read_text()
    out = lv.prepare("v", fv._build.CSRC_DIR,
                     [("decoder_layer.cu", "stop", str(phase))])
    copy = (out / "csrc" / "decoder_layer.cu").read_text()
    marker = f"\n  // {phase}. "
    assert copy.count("\n  return;" + marker) == 1
    assert copy.replace("\n  return;" + marker, marker) == src
    with pytest.raises(SystemExit):
        lv.cut(src, 11)


def test_layer_variant_constants_and_wrapper(tmp_path, monkeypatch):
    """A variant sets a kernel constant in its copy of the source and gets
    a copy of its checkout's wrapper, whose launch plan it then runs; the
    phase whose steps a variant traces is read from its source; arguments
    name the layer's sources only."""
    from avsr_tpu_torch.tools import layer_variants as lv

    name, _, subs = fv.parse("v=decoder_layer.cu:kMaxRowTiles=2,"
                             "decoder_layer.cu:kTraceSub=6", lv.SOURCES)
    monkeypatch.setattr(lv, "OUT", tmp_path / "out")
    csrc = fv._build.CSRC_DIR
    out = lv.prepare(name, csrc, subs)
    source = out / "csrc" / "decoder_layer.cu"
    assert "constexpr int kMaxRowTiles = 2;" in source.read_text()
    assert lv.trace_sub(source) == 6
    assert lv.trace_sub(csrc / "decoder_layer.cu") == 99
    spec = importlib.util.spec_from_file_location(
        "variant_layer", out / "py" / "decoder_layer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.launch_plan(24, 1024, 3072, 132, 16).rows == (16, 8, 8, 8,
                                                             16, 8)
    for arg in ("v=topk.cu:kThreads=2", "v=decoder_layer.py:X=1"):
        with pytest.raises(SystemExit):
            fv.parse(arg, lv.SOURCES)


def test_layer_variant_register_report():
    """Registers and spills of each layer-kernel instantiation, and of no
    other kernel, are read from a ptxas report."""
    from avsr_tpu_torch.tools import layer_variants as lv

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120decoder_layer_kernelI13__nv_bfloat16S1_EEvN"
        "S_4ArgsIT_T0_EE' for 'sm_90a'",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_Z12topk_kernelPKf' for "
        "'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    lines = lv.registers(log)
    assert len(lines) == 2
    assert "decoder_layer_kernel" in lines[0] and "128 registers" in lines[0]
    assert "spill stores" in lines[1]


def test_layer_variant_options_reach_every_run(monkeypatch):
    """``--dtype`` and ``--width`` are read anywhere on the command line
    (bf16 at C=1024 by default; the two decoders' widths only), the rest
    goes to the variants, and each variant's run process gets both."""
    from avsr_tpu_torch.tools import layer_variants as lv

    opts, rest = lv.options(["--dtype", "float32", "base", "--width", "768",
                             "parent@build/parent/avsr_tpu_torch/csrc"])
    assert (opts.dtype, opts.width) == ("float32", 768)
    assert rest == ["base", "parent@build/parent/avsr_tpu_torch/csrc"]
    opts, rest = lv.options(["--run", "base"])
    assert (opts.dtype, opts.width, rest) == ("bfloat16", 1024,
                                              ["--run", "base"])
    assert lv.HEADS == {1024: 16, 768: 12}
    assert lv.LIMITS == {"bfloat16": 2e-2, "float32": 2e-5}
    for bad in (["--width", "512"], ["--dtype", "float16"]):
        with pytest.raises(SystemExit):
            lv.options(bad)
    runs, built = [], []

    class Proc:
        def __init__(self, cmd, cwd):
            built.append(cmd)

        def wait(self):
            return 0

    monkeypatch.setattr(fv.subprocess, "Popen", Proc)
    monkeypatch.setattr(fv.subprocess, "run",
                        lambda cmd, cwd, check: runs.append(cmd))
    monkeypatch.setattr(lv, "prepare", lambda *a: None)
    assert lv.main(["base", "--dtype", "float32", "--width", "768",
                    "sub1=decoder_layer.cu:kTraceSub=1"]) == 0
    assert [c[-2:] for c in built] == [["--build", "base"],
                                       ["--build", "sub1"]]
    assert [c[3:] for c in runs] == [
        ["--run", name, "--dtype", "float32", "--width", "768"]
        for name in ("base", "sub1")]
    seen = []
    monkeypatch.setattr(lv, "run", lambda *a: seen.append(a))
    assert lv.main(["--run", "base", "--dtype", "float32", "--width",
                    "768"]) == 0
    assert seen == [("base", "float32", 768)]


def test_layer_trace_tables():
    """Phase work is the median block's end minus start, the barrier the
    last arrival to the first departure; a step's time is after its
    phase's start, over the blocks that marked it."""
    from avsr_tpu_torch.tools import layer_variants as lv

    # two blocks, two phases, then two step slots of phase 1
    marks = [[1000, 3000, 4000, 9000, 5000, 0],
             [1500, 3500, 4200, 8000, 6000, 7000],
             [0, 0, 0, 0, 0, 0]]  # a block the grid did not have
    assert lv.phase_times(marks, 2) == [(2.0, 0.5), (4.4, 0)]
    assert lv.step_times(marks, 2, 1, 2) == [1.4, 2.8]


# ------------------------------------------------- decode_numerics


def test_decode_numerics_exact_and_apart():
    """``exact`` keeps the twin's rounding points (fp32 throughout: within
    fp32 summation error of the twin; a bf16 cache: the twin's p and out
    roundings, so within one bf16 ulp) and leaves the cache untouched;
    ``apart`` counts the bf16 outputs more than 1e-3 apart and those one
    ulp apart."""
    import torch

    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.tools import decode_numerics as dn
    from tests.torch_port_common import decode_case

    q, kv, row, bias = (torch.from_numpy(a) for a in decode_case(
        3, b=2, k=3, s_max=32, heads=4, dh=16, pos=20, q_scale=0.25))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        cache = kv.to(dtype)
        before = cache.clone()
        want = pda.decode_attention_plain(20, q.to(dtype), cache.clone(),
                                          bias, 3, 4, row)[0]
        got = dn.exact(20, q.to(dtype), cache, bias, 3, 4, row)
        assert torch.equal(cache, before)
        assert got.dtype == dtype
        assert (got.float() - want.float()).abs().max() <= tol
    a = torch.tensor([0.3, 0.1, 0.2, -0.4], dtype=torch.bfloat16)
    b = a.clone()
    b[0] = (a[0].view(torch.int16) + 1).view(torch.bfloat16)
    b[3] = (a[3].view(torch.int16) + 2).view(torch.bfloat16)
    assert dn.apart(a, b).endswith("(2 > 1e-3, 1 of them one ulp)")
    assert dn.apart(a.float(), a.float()) == "0.000e+00"


# ------------------------------------------------- topk_stem_variants


def test_topk_stem_variant_arguments_and_sources(tmp_path, monkeypatch):
    """A variant names the top-k or stem source's constants only; its copy
    differs in the named constant; ``NAME@DIR`` brings DIR's checkout's
    wrappers of both kernels."""
    from avsr_tpu_torch.tools import topk_stem_variants as tv

    name, _, subs = fv.parse("v=topk.cu:kThreads=512,stem_fuse.cu:"
                             "kStripRows=3", tv.SOURCES)
    assert subs == [("topk.cu", "kThreads", "512"),
                    ("stem_fuse.cu", "kStripRows", "3")]
    for bad in ("v=decoder_layer.cu:kTraceSub=2", "v=topk.py:X=1"):
        with pytest.raises(SystemExit):
            fv.parse(bad, tv.SOURCES)
    monkeypatch.setattr(tv, "OUT", tmp_path / "out")
    out = tv.prepare(name, fv._build.CSRC_DIR, subs)
    assert "constexpr int kThreads = 512;" in (out / "csrc" / "topk.cu"
                                               ).read_text()
    assert "constexpr int kStripRows = 3;" in (out / "csrc" / "stem_fuse.cu"
                                               ).read_text()
    assert sorted(f.name for f in (out / "py").iterdir()) == [
        "row_gather.py", "stem_fuse.py", "topk.py"]
    old = tmp_path / "old" / "avsr_tpu_torch"
    (old / "csrc").mkdir(parents=True)
    (old / "ops" / "kernels").mkdir(parents=True)
    (old / "csrc" / "topk.cu").write_text("// another version\n")
    (old / "ops" / "kernels" / "topk.py").write_text("# old wrapper\n")
    out = tv.prepare("parent", old / "csrc", [])
    assert (out / "csrc" / "topk.cu").read_text() == "// another version\n"
    assert [f.name for f in (out / "py").iterdir()] == ["topk.py"]


def test_topk_stem_variant_register_report_and_dz(tmp_path, monkeypatch):
    """Registers and spills of the top-k and bwd1 kernels, and of no other,
    come from a ptxas report; dz digests are compared with the first
    variant's."""
    from avsr_tpu_torch.tools import topk_stem_variants as tv

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115topk_row_kernelILi4EEEvPKfPfPxiii' for 'sm_90a'",
        "ptxas info    : Used 64 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111bwd1_kernelI13__nv_bfloat16Li2EEEvNS_8Bwd1Args"
        "IT_EE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_Z12stats_kernelPKf' for "
        "'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    lines = tv.registers(log)
    assert len(lines) == 2
    assert "topk_row_kernel" in lines[0] and "64 registers" in lines[0]
    assert "bwd1_kernel" in lines[1] and "spill stores" in lines[1]
    monkeypatch.setattr(tv, "OUT", tmp_path)
    for name, digest in (("base", "ab"), ("same", "ab"), ("other", "cd")):
        (tmp_path / name).mkdir()
        (tmp_path / name / "dz.sha256").write_text(digest + "\n")
    assert tv.same_digest(["base", "same", "other", "missing"]) == {
        "base": True, "same": True, "other": False, "missing": False}


def test_topk_stem_variant_times_the_gather_pair_and_the_fused_entry(
        monkeypatch, capsys):
    """The pre-beam's row gather, run as the tool runs it but on the CPU
    (the wrappers' twins, a timer that only calls): the unfused pair and
    ``topk_gather_rows`` give the same ids and rows, both printed; a
    parent's ``topk.py`` without the fused entry prints the pair alone.
    ``row_gather.cu`` is one of the tool's sources."""
    import types

    import torch

    from avsr_tpu_torch.ops.kernels import row_gather as prg
    from avsr_tpu_torch.ops.kernels import topk as ptk
    from avsr_tpu_torch.tools import topk_stem_variants as tv

    assert fv.parse("v=row_gather.cu:kThreads=64", tv.SOURCES)[2] == [
        ("row_gather.cu", "kThreads", "64")]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cs = types.SimpleNamespace(
        VOCAB=61, cuda_ms=lambda fn: (fn(), 0.0)[1],
        bound=lambda nbytes, ops, kind: (nbytes * 1e-9, "bytes"),
        nbytes=lambda *xs: sum(x.numel() * x.element_size() for x in xs))
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cpu")
    tv.gather_case(torch, cs, "base", ptk, prg, ptk, g, dev, 2, 3, 4, 20)
    parent = types.SimpleNamespace(topk_lastdim=ptk.topk_lastdim)
    tv.gather_case(torch, cs, "parent", parent, prg, ptk, g, dev, 2, 3, 4, 20)
    out = capsys.readouterr().out.splitlines()
    assert "(exact True), topk_gather_rows 0.0000 ms (the pair's bit for " \
        "bit True)" in out[0]
    assert "(exact True); bound" in out[1] and "topk_gather_rows" not in out[1]
    assert all(k > 32 or b * lanes > 8 for b, lanes, k, _ in tv.GATHERS)


# ------------------------------------------------- bookkeeping_apply_variants


def test_bookkeeping_apply_variant_arguments_and_sources(tmp_path,
                                                         monkeypatch):
    """A variant names the bookkeeping or stem source's constants only; its
    copy differs in the named constant and carries both wrappers;
    ``kTrace=1`` makes it a traced variant, whose marks become phase times
    in ns (SM clocks scaled by the global timer over the launch)."""
    from avsr_tpu_torch.tools import bookkeeping_apply_variants as bv

    name, _, subs = fv.parse("v=beam_update.cu:kItems=2,beam_update.cu:"
                             "kTrace=1,stem_fuse.cu:kStripRows=4",
                             bv.SOURCES)
    assert subs == [("beam_update.cu", "kItems", "2"),
                    ("beam_update.cu", "kTrace", "1"),
                    ("stem_fuse.cu", "kStripRows", "4")]
    for bad in ("v=topk.cu:kThreads=2", "v=beam_update.py:X=1",
                "v=beam_update.cu:kItems=two"):
        with pytest.raises(SystemExit):
            fv.parse(bad, bv.SOURCES)
    monkeypatch.setattr(bv, "OUT", tmp_path / "out")
    out = bv.prepare(name, fv._build.CSRC_DIR, subs)
    src = (out / "csrc" / "beam_update.cu").read_text()
    assert "constexpr int kItems = 2;" in src
    assert "constexpr int kStripRows = 4;" in (
        out / "csrc" / "stem_fuse.cu").read_text()
    assert sorted(f.name for f in (out / "py").iterdir()) == [
        "beam_update.py", "stem_fuse.py"]
    assert bv.traced(out) and not bv.traced(bv.prepare(
        "plain", fv._build.CSRC_DIR, []))
    assert bv.DIGESTS[:2] == ("b8.sha256", "b8wide.sha256")
    assert all(k > 16 or k * (sp + 1) > 128 for _, k, sp, _, _ in bv.WIDE)
    marks = [[100, 300, 700, 1100], [5000, 5100, 5300, 5500]]
    assert bv.phase_ns(marks) == [100.0, 200.0, 200.0]
    assert len(bv.PHASES) + 1 == int(re.search(
        r"constexpr int kMarks = (\d+);", src).group(1))


# ------------------------------------------------------------ trace parser

REPO = Path(__file__).resolve().parents[1]
FLASH = "void (anonymous namespace)::flash_fwd_mma<64>(__nv_bfloat16 const*)"
# device events: (name, stream, start, duration) in µs; on stream 7 "k2"
# nests in "k1", stream 8 overlaps stream 7
DEVICE = [("k1", 7, 0.0, 10.0), ("k2", 7, 2.0, 3.0), (FLASH, 7, 20.0, 5.0),
          ("k3", 8, 8.0, 6.0), ("Memcpy HtoD (Pageable -> Device)", 8, 30.0,
                                2.0)]


def _torch_trace():
    """A torch.profiler Chrome trace of DEVICE with its host side: the main
    thread's port frames (one torch frame between), the runtime launches,
    two forward ops of one sequence number (the later made the autograd
    node), and the autograd thread's backward node launching k3;
    the memcpy has no launch, and a user annotation spans the device."""
    host, bwd = (100, 100), (100, 200)

    def x(cat, name, lane, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": lane[0],
                "tid": lane[1], "ts": ts, "dur": dur, "args": args}

    ev = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
           "args": {"name": "python"}}]
    for i, (name, stream, ts, dur) in enumerate(DEVICE):
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        corr = {} if cat == "gpu_memcpy" else {"correlation": i + 1}
        ev.append(x(cat, name, (0, stream), ts, dur, stream=stream, **corr))
    ev += [
        x("gpu_user_annotation", "train_step", (0, 7), 0.0, 40.0),
        x("python_function", "avsr_tpu_torch/models/e2e.py(10): forward",
          host, -50.0, 100.0),
        x("python_function", "torch/nn/modules/module.py(1): _call_impl",
          host, -40.0, 30.0),
        x("python_function", "avsr_tpu_torch/ops/kernels/flash_attention.py"
          "(254): flash_attention_fwd", host, 10.0, 5.0),
        x("python_function", "avsr_tpu_torch/models/avhubert.py(5): "
          "forward", host, -48.0, 4.0),
        x("cpu_op", "aten::view", host, -47.0, 1.0, **{
            "Sequence number": 5, "Fwd thread id": 0}),
        x("cpu_op", "aten::mm", host, -12.0, 4.0, **{
            "Sequence number": 5, "Fwd thread id": 0}),
        x("cuda_runtime", "cudaLaunchKernel", host, -30.0, 1.0,
          correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", host, -20.0, 1.0,
          correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", host, 12.0, 1.0,
          correlation=3),
        x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", bwd,
          60.0, 10.0, **{"Sequence number": 5, "Fwd thread id": 1}),
        x("cuda_runtime", "cudaLaunchKernel", bwd, 62.0, 1.0,
          correlation=4),
    ]
    return ev


def test_trace_self_times_busy_and_sources():
    """Self time lane by lane (k1 10 - its child k2's 3), the busy union
    over both streams ([0, 14] + [20, 25] + [30, 32] = 21 µs), the
    annotation span left out, the port kernel named by its wrapper, and
    each op charged to the port module that launched it: the innermost
    port frame at the launch (the torch frame between does not count),
    the backward node's launch to the module of the last forward op of
    its sequence number, and a copy
    with no launch to ``other``."""
    from avsr_tpu_torch.tools import trace

    s = trace.summarize(_torch_trace())
    assert {k: v[0] * 1e3 for k, v in s.ops.items()} == pytest.approx(
        {"k1": 7.0, "k2": 3.0, FLASH: 5.0, "k3": 6.0,
         "Memcpy HtoD (Pageable -> Device)": 2.0})
    assert all(v[1] == 1 for v in s.ops.values())
    assert s.busy_ms * 1e3 == pytest.approx(21.0)
    assert s.total_ms * 1e3 == pytest.approx(23.0)
    assert (s.events, s.lanes) == (5, 2)
    assert s.kernels == {"flash_attention_fwd": [pytest.approx(0.005), 1.0]}
    assert {k: v * 1e3 for k, v in s.sources.items()} == pytest.approx(
        {"models/e2e.py": 10.0, "ops/kernels/flash_attention.py": 5.0,
         "models/e2e.py backward": 6.0, "other": 2.0})
    assert s.op_sources["k3"] == "models/e2e.py backward"
    assert s.op_sources[FLASH] == "ops/kernels/flash_attention.py"
    # library kernels that share a port kernel's bare name are not the
    # port's: they sit in a named namespace, or in none
    names = ("void at::native::(anonymous namespace)::apply_kernel<float>"
             "(float*)", "void cub::stats_kernel<int>(int*)", "bwd1_kernel(",
             "void (anonymous namespace)::apply_kernel_v2<float>(float*)")
    ev = _torch_trace() + [
        {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 9,
         "ts": 40.0 + 2 * i, "dur": 1.0, "args": {"stream": 9}}
        for i, name in enumerate(names)]
    lib = trace.summarize(ev)
    assert set(lib.ops) == set(s.ops) | set(names)
    assert lib.kernels == s.kernels
    two = trace.summarize(_torch_trace() + [
        dict(e, ts=e["ts"] + 1000.0) for e in _torch_trace()
        if e["ph"] == "X"], steps=2)
    assert two.ops["k1"] == [pytest.approx(0.007), 1.0]
    assert two.busy_ms == pytest.approx(s.busy_ms)


def _jax_parse_trace():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_train", REPO / "tools" / "profile_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parse_trace


def test_trace_matches_the_jax_parser(tmp_path):
    """DEVICE in the JAX trace's layout (a TPU process with two op lanes,
    a step lane and a module lane, and a host process) through the JAX
    package's ``parse_trace`` gives the same per-op self times and
    counts as the port's parser on the torch layout."""
    from avsr_tpu_torch.tools import trace

    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "/host:CPU"}},
          {"ph": "M", "name": "thread_name", "pid": 1, "tid": 9,
           "args": {"name": "Steps"}},
          {"ph": "M", "name": "thread_name", "pid": 1, "tid": 10,
           "args": {"name": "XLA Modules"}}]
    for tid in (7, 8):
        ev.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                   "args": {"name": "XLA Ops"}})
    for name, stream, ts, dur in DEVICE:
        ev.append({"ph": "X", "name": name, "pid": 1, "tid": stream,
                   "ts": ts, "dur": dur})
    ev += [{"ph": "X", "name": "step 0", "pid": 1, "tid": 9, "ts": 0.0,
            "dur": 40.0},
           {"ph": "X", "name": "jit_step", "pid": 1, "tid": 10, "ts": 0.0,
            "dur": 40.0},
           {"ph": "X", "name": "host op", "pid": 2, "tid": 1, "ts": 0.0,
            "dur": 40.0}]
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": ev}, f)
    per_op, n_op, total, _ = _jax_parse_trace()(str(tmp_path), 1)
    s = trace.summarize(_torch_trace())
    assert {k: v[0] for k, v in s.ops.items()} == pytest.approx(
        dict(per_op))
    assert {k: v[1] for k, v in s.ops.items()} == dict(n_op)
    assert s.total_ms == pytest.approx(total)


def test_trace_names_every_cuda_kernel_by_its_wrapper():
    """``trace.KERNELS`` holds exactly the ``__global__`` functions of
    ``csrc/*.cu``, each mapped to a wrapper that counts its launches."""
    import importlib

    from avsr_tpu_torch.tools import trace

    found = set()
    for src in (REPO / "avsr_tpu_torch" / "csrc").glob("*.cu"):
        text = src.read_text()
        found |= set(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\((?:[^()]|"
            r"\([^()]*\))*\)\s+)?(?:void\s+)?(\w+)\s*\(", text))
        # the parser knows them by the file-level anonymous namespace
        for at in (m.start() for m in re.finditer(r"__global__", text)):
            assert text.rfind("\nnamespace {\n", 0, at) > text.rfind(
                "\n}  // namespace", 0, at), (src.name, at)
            assert "\n}  // namespace" in text[at:], (src.name, at)
    assert found == set(trace.KERNELS)
    for wrapper in set(trace.KERNELS.values()):
        mods = [importlib.import_module(f"avsr_tpu_torch.ops.kernels.{m}")
                for m in ("flash_attention", "decode_attention",
                          "decoder_layer", "beam_update", "row_gather",
                          "scan_logsumexp", "topk", "stem_fuse",
                          "ctc_loss")]
        fns = [getattr(m, wrapper) for m in mods if hasattr(m, wrapper)]
        assert len(fns) == 1 and hasattr(fns[0], "launches"), wrapper


def test_trace_of_a_cpu_profile():
    """A real torch.profiler run (the CPU, Python stacks on) exports and
    parses: no device events, so no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avsr_tpu_torch.tools import trace

    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        torch.ones(4).sum()
    ev = trace.events_of(prof)
    assert any(e.get("cat") == "cpu_op" for e in ev)
    s = trace.summarize(ev)
    assert (s.events, s.busy_ms, s.ops, s.sources) == (0, 0.0, {}, {})


# -------------------------------------------- tools that need the card


@pytest.mark.parametrize("tool", ["kernel_smoke", "profile_train",
                                  "profile_decode", "bench_data"])
def test_card_tools_refuse_to_run_without_a_card(tool):
    """Without CUDA each card tool exits non-zero and says so; none falls
    back to the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", f"avsr_tpu_torch.tools.{tool}"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert "OK" not in out.stdout


# ------------------------------------------------------------- dry run


def test_entry_loss_matches_jax():
    """``dryrun.entry`` on the CPU at the tiny config (``TINY_KW``): its
    seed-0 weights (the explicit argument) cross to JAX through the JAX
    package's ``torch_to_flax``, and the loss of the entry's b=1, t=8,
    l=6 inputs is within 2e-4 of JAX ``model.apply(...).loss`` on the
    same arrays."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import torch

    from avsr_tpu.core.checkpoint import torch_to_flax
    from avsr_tpu.models.e2e import AVSRModel
    from avsr_tpu_torch import dryrun
    from tests.torch_port_common import port_cfg, setup_torch, tiny_cfg

    setup_torch()
    cfg = tiny_cfg()
    cfg.encoder.use_flash_attention = False
    fn, args = dryrun.entry("cpu", port_cfg(cfg))
    variables = torch_to_flax({k: v.numpy() for k, v in args[0].items()},
                              cfg, prefix="")
    inputs = [a.numpy() for a in args[1:]]
    assert [x.shape for x in inputs] == [(1, 8, 88, 88, 1), (1, 8, 104),
                                         (1, 6), (1,), (1,)]
    want = jax.jit(lambda v, *a: AVSRModel(cfg).apply(v, *a).loss)(
        variables, *(jnp.asarray(x.astype(np.int32) if x.dtype == np.int64
                                 else x) for x in inputs))
    with torch.no_grad():
        got = fn(*args).item()
    np.testing.assert_allclose(got, float(want), rtol=2e-4)


def test_dryrun_multichip_two_processes():
    """``dryrun_multichip(2)`` in a fresh process: two ranks over gloo take
    one data-parallel train step and decode one utterance each; rank 0
    prints the mesh, the loss and gradient norm, and both token lists'
    lengths; no JAX is loaded."""
    code = ("import sys; from avsr_tpu_torch.dryrun import dryrun_multichip;"
            " dryrun_multichip(2); bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'avsr_tpu')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()[-2:]
    assert re.fullmatch(r"dryrun_multichip\(2\): mesh=\{'data': 2, "
                        r"'model': 1\} loss=\d+\.\d{4} grad_norm=\d+\.\d{4}",
                        lines[0]), lines
    assert re.fullmatch(r"dryrun_multichip\(2\): decode mesh=.* beam decode "
                        r"ok \(lens=\[\d+, \d+\]\)", lines[1]), lines


# ------------------------------------------------------------ bench_data


def _json_keys(path: Path) -> set:
    """The keys of the dict literal the script passes to json.dumps."""
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps of a dict literal in {path}")


def test_bench_data_tiny_on_the_cpu(monkeypatch, capsys, tmp_path):
    """``bench_data.main`` at the tiny config on the CPU, one worker, 2
    soak steps, over a pool of 3 clips of 12-20 frames in 16-frame
    buckets (the 3-10 s clips and their 256-frame buckets take ~1 min
    there): the printed record has the root script's keys, every rate
    is positive and finite, the host-supply rows cover threads with the
    native fbank on and off and a spawn process, and the pool's directory
    is removed."""
    import torch

    from avsr_tpu_torch.data import media
    from avsr_tpu_torch.tools import bench_data
    from avsr_tpu_torch.train import loop
    from tests.torch_port_common import tiny_port_cfg

    def short_pool(root, n_clips, seed=0):
        rng = np.random.RandomState(seed)
        samples = []
        for i in range(n_clips):
            frames = int(rng.randint(12, 20))
            path = os.path.join(root, f"clip_{i:03d}.mp4")
            media.save_video(path, rng.randint(0, 256, (frames, 96, 96))
                             .astype(np.uint8))
            media.save_audio(path[:-4] + ".wav",
                             (rng.randn(frames * 640) * 0.1)
                             .astype(np.float32))
            samples.append({"video": path, "label": "THE QUICK BROWN FOX"})
        return samples

    monkeypatch.setattr(bench_data, "build_fixture_pool", short_pool)
    monkeypatch.setattr(loop, "T_BUCKETS", (16, 128))
    torch.set_num_threads(2)
    rec = bench_data.main(["--steps", "2", "--batch", "1", "--grad_accum",
                           "2", "--clips", "3", "--workers", "1",
                           "--host_batches", "1"], tiny_port_cfg(), "cpu",
                          root=str(tmp_path))
    assert not list(tmp_path.iterdir())  # the pool's directory is gone
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == rec
    assert _json_keys(REPO / "bench_data.py") <= set(rec)
    rows = rec["host_supply"]
    assert {(r["native_fbank"], r["workers"], r["processes"]) for r in rows
            } >= {(False, 0, False), (False, 1, False)}
    assert any(r["processes"] for r in rows)
    rates = [rec["device_demand_samples_per_s"],
             rec["end_to_end_samples_per_s"]] + [
        r["samples_per_s"] for r in rows]
    assert all(np.isfinite(r) and r > 0 for r in rates)
    assert rec["device"] == "cpu" and rec["card"] is None
