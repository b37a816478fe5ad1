"""The port's kernel-variant tool on the CPU: how it reads variants and
writes their sources (building and timing them needs the card)."""

import re
from pathlib import Path

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
