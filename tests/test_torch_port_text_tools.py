"""The port's forced alignment, tokenizer tools and dialog collator against
the JAX package's, on the CPU.

- ``avsr_tpu_torch/decode/forced_align.py`` against the JAX Viterbi (not
  the original reference's, whose s=0 transition wraps; ROADMAP C7):
  equal alignments and scores within 1e-5 on batched, padded inputs with
  ties, repeated labels, empty transcripts and frames past each length.
- ``data/spm_train.py``: the same pieces and ``ModelProto`` bytes, byte
  for byte, on the same corpora, and the same units file.
- ``data/spm_tools.py``: ``encode_lines``, ``build_units`` and ``main``.
- ``data/dialog_dataset.py``: the same batch as the JAX collator's from a
  sample with segment times (the full file decoded).
"""

from __future__ import annotations

import io
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.data import spm_tools as jtools  # noqa: E402
from avsr_tpu.data import spm_train as jtrain  # noqa: E402
from avsr_tpu.decode import forced_align as jfa  # noqa: E402
from avsr_tpu_torch.data import spm_tools as ptools  # noqa: E402
from avsr_tpu_torch.data import spm_train as ptrain  # noqa: E402
from avsr_tpu_torch.decode import forced_align as pfa  # noqa: E402
from tests.test_spm_train import CORPUS  # noqa: E402
from tests.test_torch_port_host import CORPUS as HOST_CORPUS  # noqa: E402

# ---------------------------------------------------------------- forced_align


def _align_case(seed, v=12, b=4):
    """Batched, padded log-probs (B, T, V): utterance 1 shorter than the
    padded T, 2 with an empty transcript, 3 with repeated labels and
    log-probs on a coarse grid (ties between paths)."""
    rng = np.random.RandomState(seed)
    t_max = int(rng.randint(10, 18))
    lens = np.asarray([t_max, t_max - 4, t_max - 2, t_max - 1])[:b]
    llens = np.asarray([4, 2, 0, 3])[:b]
    logp = np.log(rng.dirichlet(np.ones(v), size=(b, t_max))).astype(
        np.float32)
    logp[3] = np.round(logp[3] * 2) / 2  # ties
    labels = rng.randint(1, v, size=(b, 4))
    labels[3, :3] = [5, 5, 7]
    labels[np.arange(4)[None, :] >= llens[:, None]] = 0
    return logp, lens, labels, llens


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_forced_align_matches_jax(seed):
    logp, lens, labels, llens = _align_case(seed)
    want, want_score = jfa.forced_align(
        jnp.asarray(logp), jnp.asarray(lens), jnp.asarray(labels, jnp.int32),
        jnp.asarray(llens))
    got, score = pfa.forced_align(torch.from_numpy(logp),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(llens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               rtol=1e-5, atol=1e-5)
    assert (got.numpy()[1, lens[1]:] == 0).all()


def test_forced_align_single_frame_and_blank_id():
    """T = 1, and a blank id other than 0."""
    rng = np.random.RandomState(7)
    logp = np.log(rng.dirichlet(np.ones(6), size=(2, 1))).astype(np.float32)
    labels = np.asarray([[3], [4]])
    llens = np.asarray([1, 0])
    for blank in (0, 5):
        want, ws = jfa.forced_align(jnp.asarray(logp), jnp.asarray([1, 1]),
                                    jnp.asarray(labels, jnp.int32),
                                    jnp.asarray(llens), blank)
        got, gs = pfa.forced_align(torch.from_numpy(logp),
                                   torch.tensor([1, 1]),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(llens), blank)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-5)


def test_interpolate_blank_matches_jax():
    labels = np.asarray([[3, 4, 5], [7, 0, 0]])
    for blank in (0, 9):
        np.testing.assert_array_equal(
            pfa.interpolate_blank(torch.from_numpy(labels), blank).numpy(),
            np.asarray(jfa.interpolate_blank(jnp.asarray(labels), blank)))


# ---------------------------------------------------------------- spm_train


@pytest.mark.parametrize("corpus,vocab,max_len", [
    ("spm", 80, 8), ("spm", 40, 4), ("host", 60, 8)])
def test_spm_train_proto_bytes_match_jax(corpus, vocab, max_len, tmp_path):
    """The same pieces, scores and types, and the same ``ModelProto``
    bytes, from the port's trainer and the JAX package's."""
    lines = CORPUS if corpus == "spm" else HOST_CORPUS
    got = ptrain.train_unigram(lines, vocab, max_len)
    want = jtrain.train_unigram(lines, vocab, max_len)
    assert [(p.piece, p.score, p.type) for p in got] == [
        (p.piece, p.score, p.type) for p in want]
    blob = ptrain.serialize_model_proto(got)
    assert blob == jtrain.serialize_model_proto(want)
    ptrain.save_model(got, str(tmp_path / "p.model"))
    jtrain.save_model(want, str(tmp_path / "j.model"))
    assert (tmp_path / "p.model").read_bytes() == (tmp_path / "j.model"
                                                   ).read_bytes() == blob


def test_spm_train_and_save_matches_jax(tmp_path):
    """train.sh's pipeline: the model bytes and the units file."""
    corpus = tmp_path / "input.txt"
    corpus.write_text("\n".join(CORPUS))
    ptrain.train_and_save(str(corpus), str(tmp_path / "p"), 80, 8)
    jtrain.train_and_save(str(corpus), str(tmp_path / "j"), 80, 8)
    for suffix in (".model", "_units.txt"):
        assert (tmp_path / f"p{suffix}").read_bytes() == (
            tmp_path / f"j{suffix}").read_bytes()
    with pytest.raises(ValueError):
        ptrain.train_unigram([])


# ---------------------------------------------------------------- spm_tools


def test_spm_tools_match_jax(tmp_path, monkeypatch, capsys):
    model = str(tmp_path / "m.model")
    jtrain.save_model(jtrain.train_unigram(CORPUS, 60, 8), model)
    lines = CORPUS[:8] + ["ZEBRA 123 QUICKEST", "", "  THE   DOG  "]
    assert list(ptools.encode_lines(model, lines)) == list(
        jtools.encode_lines(model, lines))
    assert ptools.build_units(model, lines) == jtools.build_units(model, lines)
    text = tmp_path / "in.txt"
    text.write_text("\n".join(lines))
    outs = []
    for mod in (ptools, jtools):
        for extra in ([], ["--units"]):
            monkeypatch.setattr(sys, "argv", ["spm_tools", "--model", model,
                                              *extra, str(text)])
            mod.main()
            outs.append(capsys.readouterr().out)
        monkeypatch.setattr(sys, "stdin", io.StringIO("HELLO THE DOG\n"))
        monkeypatch.setattr(sys, "argv", ["spm_tools", "--model", model])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[:3] == outs[3:]
    assert outs[1].splitlines()[0] == "<unk> 1"


# ---------------------------------------------------------------- dialog


def test_dialog_collator_matches_jax(tmp_path):
    """A sample with segment times decodes the whole file, as the JAX
    collator does: the same batch, key by key."""
    pytest.importorskip("cv2")
    from avsr_tpu.data.dialog_dataset import DialogDataCollator as JD
    from avsr_tpu_torch.data.dialog_dataset import DialogDataCollator as PD
    from tests.test_torch_port_host import write_fixture
    from tests.torch_port_common import jax_fbank_native

    from avsr_tpu_torch.ops import fbank as pfbank

    path = str(tmp_path / "clip.mp4")
    write_fixture(path, 20, seed=4)
    sample = {"video": path, "start_time": 0.2, "end_time": 0.4}
    saved = pfbank.USE_NATIVE
    pfbank.USE_NATIVE = jax_fbank_native()
    try:
        got = PD()([sample])
    finally:
        pfbank.USE_NATIVE = saved
    want = JD()([sample])
    assert got["video_lengths"][0] == 20
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
