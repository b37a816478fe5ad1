"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_port_*).

Weights come from the JAX side: the tiny config of ``tests/torch_ref.py``,
``model.init`` with ``PRNGKey(0)``, BN statistics randomised with numpy so
eval-mode BN is a real test, then ``flax_to_torch`` into the port. The JAX
side keeps the JAX package's config; the port gets its own copy of it
(``port_cfg``), as a user of the port would.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def setup_torch():
    """fp32 on the CPU, no TF32, two threads (tier-1 runs six workers). The
    port's CPU route warms torch's CPU exp itself (``ops.cpu.warm_exp``,
    ROADMAP C21)."""
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tiny_cfg():
    from tests.torch_ref import tiny_jax_config

    cfg = tiny_jax_config()
    cfg.encoder.use_flash_attention = True
    cfg.decode_fused_attention = True
    return cfg


def jax_tiny_model(cfg, seed: int = 0):
    """(flax AVSRModel, variables with randomised BN statistics)."""
    import jax
    import jax.numpy as jnp

    from avsr_tpu.models.e2e import AVSRModel

    # the kernel switches leave the parameter tree unchanged: initialise
    # through the plain paths, jitted (several times faster on the CPU)
    plain = copy.deepcopy(cfg)
    plain.encoder.use_flash_attention = False
    plain.decode_fused_attention = False
    variables = jax.jit(lambda key: AVSRModel(plain).init(
        {"params": key},
        jnp.zeros((1, 4, 88, 88, 1)), jnp.zeros((1, 4, 104)),
        jnp.asarray([[3, 4]], jnp.int32), jnp.asarray([4], jnp.int32),
        jnp.asarray([2], jnp.int32),
    ))(jax.random.PRNGKey(seed))
    model = AVSRModel(cfg)
    rng = np.random.RandomState(seed + 1)

    def randomise(path, leaf):
        if path[-1].key == "mean":
            return jnp.asarray(0.1 * rng.randn(*leaf.shape), jnp.float32)
        return jnp.asarray(0.5 + rng.rand(*leaf.shape), jnp.float32)

    stats = jax.tree_util.tree_map_with_path(randomise, variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def port_cfg(cfg):
    """The port's config equal to a JAX package config."""
    from avsr_tpu_torch.core.config import AVHubertAVSRConfig

    return AVHubertAVSRConfig.from_dict(cfg.to_dict())


def port_model(cfg, variables):
    """The port's model, on its own config, with the JAX variables."""
    from avsr_tpu_torch.core.weights import torch_state_from_jax
    from avsr_tpu_torch.models.e2e import AVSRModel

    pcfg = port_cfg(cfg)
    model = AVSRModel(pcfg)
    model.load_state_dict(torch_state_from_jax(variables, pcfg), strict=True)
    return model.eval()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def beam_step_case(seed: int, i: int, *, use_ctc: bool = True,
                   dyadic: bool = False, b: int = 6, k: int = 3, sp: int = 4,
                   ll: int = 24, s_rows: int = 16, eos: int = 49):
    """Random inputs of one beam bookkeeping step (``beam_update``) at step
    ``i`` as numpy arrays in the port's dtypes (int64 ids and counts, bool
    masks, fp32 scores). Lanes: 0 takes its forced last step, 1 is
    stopped, 2 is past its length (i >= 1), 3 has eos among its pre-beam
    ids and a history that triggers end detection, 4 has two hypotheses
    with equal scores (ties across the beam), 5 has a dead hypothesis and
    ends one on its own eos.
    ``dyadic`` draws every score on a 1/64 grid, where any order of fp32
    multiply-adds with weights 0.75/0.25 is exact."""
    assert b >= 6 and i >= 4
    rng = np.random.RandomState(seed)

    def scores(*shape, scale=3.0, shift=0.0):
        x = rng.randn(*shape) * scale + shift
        if dyadic:
            x = np.round(x * 64) / 64
        return x.astype(np.float32)

    xlens = rng.randint(i + 2, ll - 2, size=b).astype(np.int64)
    xlens[0] = i + 1  # forced: i >= xlen - 1
    xlens[2] = i  # past its length
    stop = np.zeros(b, bool)
    stop[1] = True
    dec_top = -np.sort(-scores(b, k, sp, shift=-4.0), axis=-1)
    dec_eos = scores(b, k, shift=-6.0)
    part_ids = np.stack([np.stack([rng.choice(np.arange(1, eos), sp,
                                              replace=False)
                                   for _ in range(k)]) for _ in range(b)])
    part_ids[3, 1, 2] = eos  # eos among the pre-beam ids: slot S' masked
    score = scores(b, k, scale=5.0, shift=-20.0)
    alive = np.ones((b, k), bool)
    alive[5, 2] = False
    psi_cand = scores(b, k, sp, scale=10.0, shift=-30.0) if use_ctc else None
    psi_eos = scores(b, k, scale=10.0, shift=-40.0) if use_ctc else None
    ctc_s = scores(b, k, scale=10.0, shift=-25.0) if use_ctc else None
    # lane 5: hypothesis 0's explicit eos slot wins (a natural end)
    dec_eos[5, 0] = 10.0
    if use_ctc:
        psi_eos[5, 0] = ctc_s[5, 0] + 5.0
    # lane 4: hypotheses 0 and 1 identical, so their candidates tie
    for arr in (dec_top, part_ids, psi_cand):
        if arr is not None:
            arr[4, 1] = arr[4, 0]
    for arr in (dec_eos, score, psi_eos, ctc_s):
        if arr is not None:
            arr[4, 1] = arr[4, 0]
    yseq = rng.randint(1, eos, size=(b, k, ll)).astype(np.int64)
    anc = rng.randint(0, k, size=(s_rows, b, k)).astype(np.int64)
    ended_best = scores(b, ll, scale=5.0, shift=-30.0)
    ended_cnt = rng.randint(0, 3, size=(b, ll)).astype(np.int64)
    ended_best[:, i:] = -1.0e30
    ended_cnt[:, i:] = 0
    best_score = scores(b, scale=5.0, shift=-15.0)
    # lane 3: the three recent lengths trail the best by more than 10
    ended_best[3, i - 4:i - 1] = best_score[3] - 20.0
    ended_cnt[3, i - 4:i - 1] = 1
    best_yseq = rng.randint(1, eos, size=(b, ll)).astype(np.int64)
    best_len = rng.randint(2, i + 2, size=b).astype(np.int64)
    return dict(xlens=xlens, dec_top=dec_top, dec_eos=dec_eos,
                psi_cand=psi_cand, psi_eos=psi_eos, ctc_s=ctc_s,
                part_ids=part_ids, score=score, alive=alive, stop=stop,
                yseq=yseq, anc=anc, ended_best=ended_best,
                ended_cnt=ended_cnt, best_score=best_score,
                best_yseq=best_yseq, best_len=best_len)


def decode_case(seed: int, b: int = 3, k: int = 3, s_max: int = 64,
                heads: int = 4, dh: int = 32, pos: int = 11,
                q_scale: float = 1.0):
    """One decode_attention step as numpy fp32 (q, kv, row, lane bias): a
    random beam ancestry over the cache, each lane its own ancestor at the
    step's row, every row past pos masked (-1e30) on every lane."""
    rng = np.random.RandomState(seed)
    n, c = b * k, heads * dh
    q = rng.randn(n, c).astype(np.float32) * np.float32(q_scale)
    kv = rng.randn(n, s_max, 2 * c).astype(np.float32)
    row = rng.randn(n, 2 * c).astype(np.float32)
    anc = rng.randint(0, k, size=(s_max, b, k))
    anc[min(pos, s_max - 1)] = np.arange(k)  # the step's row: own lane
    valid = (np.arange(s_max) <= pos)[:, None, None, None] & (
        anc[..., None] == np.arange(k))
    bias = np.where(np.transpose(valid, (1, 2, 0, 3)), 0.0, -1.0e30)
    return q, kv, row, bias.astype(np.float32)  # bias (B, K, S, J)


def c1_topk(x, k: int):
    """(values, indices) of k rounds of C1's rule (ROADMAP) per row of a
    numpy fp32 (rows, v) array, NaN never chosen: the entries above -inf by
    value descending, then index ascending; once they run out, -inf at the
    lower of the lowest index holding -inf and the lowest index chosen
    (2**31 - 1 where there is neither)."""
    rows, v = x.shape
    vals = np.full((rows, k), -np.inf, np.float32)
    ids = np.zeros((rows, k), np.int64)
    for r in range(rows):
        row = x[r]
        live = np.flatnonzero(~np.isnan(row) & (row > -np.inf))
        order = live[np.lexsort((live, -row[live]))][:k]
        vals[r, :len(order)] = row[order]
        ids[r, :len(order)] = order
        if len(order) < k:
            neg = np.flatnonzero(row == -np.inf)
            ids[r, len(order):] = min(neg.min() if len(neg) else 2**31 - 1,
                                      order.min() if len(order) else 2**31 - 1)
    return vals, ids


INT_MAX = 2**31 - 1


def order_keys(x):
    """csrc/common.cuh order_key of each fp32 value: a uint32 in the order
    of the floats, -0 as +0 (as int64)."""
    b = (np.asarray(x, np.float32) + np.float32(0)).view(np.uint32).astype(
        np.int64)
    return b ^ np.where(b >> 31, 0xFFFFFFFF, 0x80000000)


def bitonic_desc(words, per: int):
    """csrc/beam_update.cu's sort of a chunk's 32 * ``per`` order words,
    element e = per * lane + t: the bitonic network, stage (size, stride)
    a compare-exchange of e and e ^ stride (in a lane's registers below
    ``per``, else across lanes), runs whose bit ``size`` is 0 descending."""
    w = list(words)
    n = len(w)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            for e in range(n):
                x = e ^ stride
                if x > e:
                    desc = (e & size) == 0
                    if (w[x] > w[e]) == desc:
                        w[e], w[x] = w[x], w[e]
            stride //= 2
        size *= 2
    return w


def wide_topk(w, k: int, per: int = 4):
    """csrc/beam_update.cu ``beam_update_wide_kernel``'s top-k over one
    utterance's weighted candidates ``w`` (fp32, flat index f): chunks of
    32 * ``per`` candidates as order words (the value's order key above
    the complement of f; 0 for NaN and -inf) sorted by ``bitonic_desc``;
    a chunk's first min(k, 32 * per) words above 0 are its list, and its
    lowest index holding -inf is kept beside it; then each entry's place,
    the count of listed entries with a larger word. Returns the k rounds
    as (flat index, value) pairs (the value -inf from the first round
    whose maximum is -inf, with the -inf rule's index: the lower of the
    lowest index holding -inf and the lowest index chosen; 0 where every
    candidate is NaN), and the chunk each listed round came from."""
    w = np.asarray(w, np.float32)
    nc = len(w)
    chunk = 32 * per
    kc = min(k, chunk)
    keys = np.where(np.isnan(w) | (w == -np.inf), 0, order_keys(w))
    words = [int(keys[f]) << 32 | (0xFFFFFFFF - f) if keys[f] else 0
             for f in range(nc)]
    lists, infs = [], []
    for ch in range(-(-nc // chunk)):
        f0 = ch * chunk
        held = words[f0:f0 + chunk]
        ordered = bitonic_desc(held + [0] * (chunk - len(held)), per)
        lists.append([x for x in ordered[:kc] if x])
        neg = np.flatnonzero(w[f0:f0 + chunk] == -np.inf)
        infs.append(f0 + int(neg.min()) if len(neg) else INT_MAX)
    listed = [(word, ch) for ch, entries in enumerate(lists)
              for word in entries]
    placed = {}
    for word, ch in listed:
        rank = sum(other > word for other, _ in listed)
        if rank < k:
            assert rank not in placed
            placed[rank] = (0xFFFFFFFF - (word & 0xFFFFFFFF), ch)
    n_valid = min(k, len(listed))
    assert sorted(placed) == list(range(n_valid))
    chosen = [placed[r][0] for r in range(n_valid)]
    j = min(infs + chosen) if infs + chosen else INT_MAX
    j = 0 if j == INT_MAX else j
    rounds = [(f, w[f]) for f in chosen] + [(j, np.float32(-np.inf))] * (
        k - n_valid)
    return rounds, [placed[r][1] for r in range(n_valid)]


def gather_spy(monkeypatch):
    """Counts the beam's calls of the fused pre-beam top-k and CTC row
    gather (``topk_gather_rows``), which with CTC takes every step's
    pre-beam."""
    from avsr_tpu_torch.decode import beam as beam_mod

    real, calls = beam_mod.topk_gather_rows, []

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(beam_mod, "topk_gather_rows", spy)
    return calls


class DummyTokenizer:
    """``tests/test_pipeline.py``'s tokenizer without the JAX import: word
    ids in [1, 25] from a hash that is the same in every process (spawned
    collation workers import it by module name)."""

    def tokenize(self, text):
        return np.asarray(
            [(sum(ord(c) * 31 ** i for i, c in enumerate(w)) % 25) + 1
             for w in text.split()],
            np.int32,
        )


def tiny_port_cfg():
    """The tiny config of ``tests/torch_ref.py`` as the port's own config,
    built without the JAX package (for subprocesses that must not import
    it)."""
    from avsr_tpu_torch.core.config import (AVHubertAVSRConfig,
                                            AVHubertEncoderConfig)

    return AVHubertAVSRConfig(
        odim=61, adim=32, ddim=32, dheads=4, dunits=64, dlayers=2,
        encoder=AVHubertEncoderConfig(
            encoder_embed_dim=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, use_flash_attention=True),
        decode_fused_attention=True)


def jax_fbank_native() -> bool:
    """Whether the JAX package featurizes by its native library in this
    process. Its loader builds the library in place with g++ at import and
    falls back to numpy for the process's life where the build or the load
    fails; under xdist six workers import it at once, and one that loads
    another's half-written library falls back (ROADMAP C26). The numpy and
    native routes differ by up to 1e-4 (tests/test_fbank.py)."""
    from avsr_tpu.ops import fbank as jfbank

    return jfbank._NATIVE is not None and jfbank.USE_NATIVE


def pin_fbank_route(monkeypatch) -> str:
    """Make the port featurize, in this process, by the route the JAX
    package's loader took; returns it."""
    from avsr_tpu_torch.ops import fbank as pfbank

    native = jax_fbank_native()
    monkeypatch.setattr(pfbank, "USE_NATIVE", native)
    return "native" if native else "numpy"


class RoutedAudioTransform:
    """The port's audio transform, each call run with the port's fbank
    route set to ``native`` (and set back after). It pickles, so the port's
    spawned collation workers, which import the port afresh, featurize by
    that route too."""

    def __init__(self, inner, native: bool):
        self.inner = inner
        self.native = native

    def __call__(self, *args, **kw):
        from avsr_tpu_torch.ops import fbank as pfbank

        saved, pfbank.USE_NATIVE = pfbank.USE_NATIVE, self.native
        try:
            return self.inner(*args, **kw)
        finally:
            pfbank.USE_NATIVE = saved


def loop_collators(subset="test", seed=0):
    """(JAX, port) DataCollators with the same transforms and the dummy
    tokenizer (the JAX package is imported here, not with this module); the
    port's audio transform featurizes by the JAX package's route, in this
    process and in spawned workers."""
    from avsr_tpu.data import collate as jcollate
    from avsr_tpu.data import transforms as jtr
    from avsr_tpu_torch.data import collate as pcollate
    from avsr_tpu_torch.data import transforms as ptr

    return (jcollate.DataCollator(
        text_transform=DummyTokenizer(),
        video_transform=jtr.VideoTransform(subset),
        audio_transform=jtr.AudioTransform(subset), seed=seed),
        pcollate.DataCollator(
            text_transform=DummyTokenizer(),
            video_transform=ptr.VideoTransform(subset),
            audio_transform=RoutedAudioTransform(
                ptr.AudioTransform(subset), jax_fbank_native()),
            seed=seed))


LOOP_BUCKETS = (6, 12)  # frame buckets of the loop tests (both packages)


def loop_samples(n, seed=0):
    """Synthetic samples of 4-6 frames: one 6-frame bucket."""
    from avsr_tpu_torch.data.dataset import synthetic_samples

    return list(synthetic_samples(n, seed=seed, min_frames=4, max_frames=6))
