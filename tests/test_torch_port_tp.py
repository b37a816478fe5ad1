"""The port's tensor parallelism (``core/tensor_parallel.py``, the JAX
package's Megatron layout over the 'model' axis) and the fused stem under
data parallelism, on the CPU over ``gloo``.

One pair of ranks (``tests/torch_tp_worker.py``) runs data 1 x model 2
(with every dropout off, with every dropout on, with dropout and remat,
and on batches each rank collates with its own interferer pool), data 2
x model 1 and data 2 x model 1 with ``AVSR_FUSED_STEM=1``; four ranks
run data 2 x model 2; the two sets run at once, beside the JAX step and the one-process port steps
in this process. The tiny config of ``tests/torch_ref.py`` (encoder heads
2, decoder heads 4), every dropout 0 unless a case says otherwise, fp32,
modality 'av', seed-0 weights, a global batch of 4 clips of 8 frames.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.core import tensor_parallel as tp  # noqa: E402
from avsr_tpu_torch.core.checkpoint import avsr_mapping  # noqa: E402
from avsr_tpu_torch.train import trainer as PT  # noqa: E402
from tests.torch_port_common import port_cfg, setup_torch, tiny_cfg  # noqa: E402
from tests.torch_tp_worker import (case_cfg, fresh_state,  # noqa: E402
                                   no_dropout_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("loss", "loss_ctc", "loss_att", "grad_norm")
# the attention key biases' gradient is exactly 0 in exact arithmetic
# (softmax shift invariance): rounding noise of ~1e-10, held absolutely
ZERO_GRAD = ("k_proj.bias", "linear_k.bias")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world: int, out, cases):
    env = dict(os.environ, PYTHONPATH=REPO)
    worker = os.path.join(REPO, "tests", "torch_tp_worker.py")
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, worker, str(r), str(world), port, str(out), *cases],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, timeout=150):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in out, out[-3000:]


def _jax_step_metrics(state_dict, batch):
    """JAX ``train_step`` on one device over the global batch, fp32: its
    metrics (the loss and its parts at the weights given, the gradient
    norm before clipping)."""
    from avsr_tpu.core.checkpoint import torch_to_flax
    from avsr_tpu.models.e2e import AVSRModel as JaxModel
    from avsr_tpu.train import trainer as JT

    cfg = tiny_cfg()
    cfg.dropout_rate = cfg.transformer_attn_dropout_rate = 0.0
    e = cfg.encoder
    e.hidden_dropout = e.attention_dropout = e.activation_dropout = 0.0
    e.dropout_input = e.modality_dropout = 0.0
    variables = torch_to_flax({k: v.numpy() for k, v in state_dict.items()},
                              cfg, prefix="")
    jcfg = JT.TrainConfig(learning_rate=1e-3, warmup_steps=0, max_steps=10)
    tx = JT.make_optimizer(jcfg)
    state = JT.TrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    jb = {k: jnp.asarray(v.numpy().astype(np.int32) if not
                         v.is_floating_point() else v.numpy())
          for k, v in batch.items()}
    _, m = jax.jit(lambda s, b, k: JT.train_step(
        JaxModel(cfg), tx, s, b, k, "float32", "threefry2x32"))(
        state, jb, jax.random.PRNGKey(0))
    return {k: float(m[k]) for k in METRICS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results by case, the JAX step's metrics, and the
    one-process port steps on the global batch: plain and with the fused
    stem (one step), with every dropout on and with dropout and remat (two
    steps, the worker's seeds).

    The port's steps in this process run at one thread, as each rank does
    (``tests/torch_tp_worker.py``), for the whole module: the step's fp32
    sums round differently at another thread count, and the first AdamW
    update carries that, through the tiny video frontend's ill-conditioned
    gradient (ROADMAP C16), into the second step's metrics at ~1e-4, which
    is not the tensor-parallel layout's doing."""
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.data.synthetic import synthetic_train_batch
    from avsr_tpu_torch.models.e2e import AVSRModel

    setup_torch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("tp")
    model = AVSRModel(no_dropout_cfg())
    init_weights(model, torch.Generator().manual_seed(0))
    weights = model.state_dict()
    torch.save(weights, out / "weights.pt")
    batch = PT.to_device(synthetic_train_batch(
        np.random.RandomState(1), 4, 8, 5, video_lengths=[8, 7, 6, 8],
        label_lengths=[5, 4, 3, 5], vocab=59), "cpu")
    torch.save(batch, out / "batch.pt")
    pair = _spawn(2, out, ["tp", "dp", "stem", "tp_drop", "tp_remat",
                           "tp_skew"])
    quad = _spawn(4, out, ["dp_tp"])
    try:
        jax_metrics = _jax_step_metrics(weights, batch)
        one = {}
        for stem in (False, True):
            if stem:
                os.environ["AVSR_FUSED_STEM"] = "1"
            try:
                state = fresh_state(out)
                ms = [{k: v.item() for k, v in
                       PT.train_step(state, batch).items()}]
            finally:
                os.environ.pop("AVSR_FUSED_STEM", None)
            grads = {n: p.grad.clone()
                     for n, p in state.model.named_parameters()}
            one["stem" if stem else "plain"] = (ms, grads, state)
        for case in ("tp_drop", "tp_remat"):
            state = fresh_state(out, case_cfg(case))
            one[case] = [{k: v.item() for k, v in
                          PT.train_step(state, batch).items()}
                         for _ in range(2)]
    finally:
        _join(pair)
        _join(quad)
    res = {case: [torch.load(out / f"{case}_rank{r}.pt", weights_only=True)
                  for r in range(world)]
           for case, world in (("tp", 2), ("dp", 2), ("stem", 2),
                               ("tp_drop", 2), ("tp_remat", 2),
                               ("tp_skew", 2), ("dp_tp", 4))}
    state = fresh_state(out)
    one["tp_skew"] = [{k: v.item() for k, v in PT.train_step(state, b).items()}
                      for b in res["tp_skew"][0]["collated"]]
    yield res, jax_metrics, one, out, batch
    torch.set_num_threads(threads)


def test_split_rule_matches_param_partition_spec():
    """``partition_dim`` on every parameter of the tiny ``AVSRModel``
    against the JAX package's ``param_partition_spec`` on the flax leaf
    the checkpoint mapping gives it (a dense kernel (in, out) is torch's
    (out, in): JAX's split of the output axis is torch's dim 0)."""
    from jax.tree_util import DictKey

    from avsr_tpu.core.mesh import MODEL_AXIS, param_partition_spec
    from avsr_tpu_torch.models.e2e import AVSRModel

    cfg = port_cfg(tiny_cfg())
    params = dict(AVSRModel(cfg).named_parameters())
    seen = split = 0
    for tkey, fpath, _, coll in avsr_mapping(cfg, prefix=""):
        if coll != "p":
            continue
        keys = tkey if isinstance(tkey, list) else [tkey]
        stack = 1 if isinstance(tkey, list) else 0
        for key in keys:
            ndim = params[key].dim()
            spec = tuple(param_partition_spec(
                [DictKey(k) for k in fpath], np.zeros((1,) * (ndim + stack))))
            want = None
            if MODEL_AXIS in spec:
                # the flax axis that splits, without the stacking axis
                want = ndim - 1 - (spec.index(MODEL_AXIS) - stack)
            assert tp.partition_dim(key, ndim) == want, (key, spec)
            seen += 1
            split += want is not None
    assert seen == len(params)
    # q/k/v, out and the FFN's two in each encoder layer; self and source
    # q/k/v/out and the FFN's two in each decoder layer
    assert split == 2 * 6 + 2 * 10


def test_head_map_draws_the_full_calls_rows():
    """A dropout seed with a head map (``flash_attention._head_map``) draws,
    for a tensor-parallel rank's rows (batch x local heads), bit for bit
    the rows of those heads in the draw over every head; without one the
    draw is the same as before; a map outside the call's heads raises."""
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa

    seed, b, heads, local, t = (7, 11), 3, 4, 2, 9
    full = pfa.dropout_keep_mask_plain(seed, b * heads, t, 0.3).view(
        b, heads, t, t)
    for base in (0, 2):
        got = pfa.dropout_keep_mask_plain((*seed, local, heads, base),
                                          b * local, t, 0.3)
        want = full[:, base:base + local].reshape(b * local, t, t)
        assert torch.equal(got, want)
    assert torch.equal(pfa.dropout_keep_mask_plain((*seed, 1, 1, 0), 5, t,
                                                   0.3),
                       pfa.dropout_keep_mask_plain(seed, 5, t, 0.3))
    with pytest.raises(ValueError, match="head map"):
        pfa.dropout_keep_mask_plain((*seed, 2, 4, 3), 4, t, 0.3)


@pytest.mark.parametrize("case", ["tp", "dp_tp"])
def test_tensor_parallel_step_matches_jax(runs, case):
    """Data 1 x model 2 and data 2 x model 2: step 1's loss, CTC and
    attention losses and gradient norm within 1e-4 relative of the JAX
    single-device ``train_step`` on the global batch; every rank alike.
    The gathered gradients (after clipping) within 2e-4 of each tensor's
    largest entry of the port's model-size-1 step at the same data size
    (the one-process step, and data 2 x model 1): the key biases', 0 in
    exact arithmetic, within 1e-8."""
    res, jax_metrics, one, _, _ = runs
    ranks = res[case]
    assert [r["layout"] for r in ranks] == [(1, 2) if case == "tp"
                                            else (2, 2)] * len(ranks)
    for r in ranks:
        for k in METRICS:
            np.testing.assert_allclose(r["metrics"][0][k], jax_metrics[k],
                                       rtol=1e-4, err_msg=f"{case} {k}")
    ref = one["plain"][1] if case == "tp" else res["dp"][0]["grads"]
    for r in ranks:
        assert set(r["grads"]) == set(ref)
        for name, want in ref.items():
            got = r["grads"][name]
            assert got.shape == want.shape, name
            err = (got - want).abs().max().item()
            lim = 1e-8 if name.endswith(ZERO_GRAD) else (
                2e-4 * want.abs().max().item())
            assert err <= lim, f"{case} {name}: {err:.3e} > {lim:.3e}"


def test_replicas_stay_bit_equal_and_checkpoint_crosses_model_sizes(runs):
    """Data 1 x model 2: after two steps every replicated parameter is bit
    for bit the same on both ranks, and so is the gathered model; the
    ``CheckpointManager`` step written at model size 2 (model and AdamW
    moments gathered) restores in one process at model size 1 to exactly
    the gathered model, and the next step's metrics are within 1e-4 of
    step 3 at model size 2. Step 2 stays within 1e-4 of the one-process
    run of the same steps."""
    res, _, one, out, batch = runs
    a, b = res["tp"]
    assert a["replicated"] and all(
        torch.equal(a["replicated"][n], b["replicated"][n])
        for n in a["replicated"])
    assert all(torch.equal(a["full"][n], b["full"][n]) for n in a["full"])
    state = one["plain"][2]
    step2 = {k: v.item() for k, v in PT.train_step(state, batch).items()}
    for k in METRICS:
        np.testing.assert_allclose(a["metrics"][1][k], step2[k], rtol=1e-4,
                                   err_msg=k)
    mgr = PT.CheckpointManager(str(out / "ck"))
    assert mgr.steps() == [2]
    restored = mgr.restore(2, fresh_state(out))
    sd = restored.model.state_dict()
    assert set(sd) == set(a["full"])
    for n, v in a["full"].items():
        assert torch.equal(sd[n], v), n
    assert restored.step == 2
    step3 = {k: v.item() for k, v in PT.train_step(restored, batch).items()}
    for k in METRICS:
        np.testing.assert_allclose(a["metrics"][2][k], step3[k], rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["tp_drop", "tp_remat"])
def test_tensor_parallel_dropout_matches_one_process(runs, case):
    """Every dropout on (the encoder FFN's and the decoder's sliced draws,
    the flash kernels' head-mapped seed, the replicated activations'
    draws), and in ``tp_remat`` the encoder layers rematerialised in the
    backward: data 1 x model 2 gives both steps' metrics within 1e-4
    relative of the port's one-process steps with the same seeds on both
    ranks, and the replicated parameters are bit for bit the same on both
    ranks after the two steps."""
    res, _, one, _, _ = runs
    a, b = res[case]
    for r in (a, b):
        assert r["layout"] == (1, 2)
        for i, want in enumerate(one[case]):
            for k in METRICS:
                np.testing.assert_allclose(r["metrics"][i][k], want[k],
                                           rtol=1e-4,
                                           err_msg=f"{case} step {i} {k}")
    assert a["replicated"] and all(
        torch.equal(a["replicated"][n], b["replicated"][n])
        for n in a["replicated"])


def test_model_group_steps_on_its_first_ranks_batch(runs):
    """Each rank collates its own batches as the train CLI does, with the
    same seed and clips, from an interferer pool whose waves differ
    between the processes, so the two ranks' audio differs: both ranks
    step on model rank 0's batches, so their metrics are equal and those
    of the one-process steps on rank 0's batches within 1e-4, and the
    replicated parameters are bit for bit the same after two steps."""
    res, _, one, _, _ = runs
    a, b = res["tp_skew"]
    assert a["layout"] == b["layout"] == (1, 2)
    for x, y in zip(a["collated"], b["collated"]):
        assert torch.equal(x["videos"], y["videos"])
    assert any(not torch.equal(x["audios"], y["audios"])
               for x, y in zip(a["collated"], b["collated"]))
    assert a["metrics"] == b["metrics"]
    for i, want in enumerate(one["tp_skew"]):
        for k in METRICS:
            np.testing.assert_allclose(a["metrics"][i][k], want[k],
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert a["replicated"] and all(
        torch.equal(a["replicated"][n], b["replicated"][n])
        for n in a["replicated"])


def test_fused_stem_under_data_parallelism(runs):
    """``AVSR_FUSED_STEM=1`` at data 2 (the twin route: the stem's sums,
    their all-reduce over the data group, then the apply; bwd1's sums
    all-reduced before bwd2): both ranks give the metrics of the
    one-process fused-stem step on the global batch within 1e-4, and so
    does the unfused data-parallel step; both are within 1e-4 of the JAX
    single-device ``train_step`` too."""
    res, jax_metrics, one, _, _ = runs
    want = one["stem"][0][0]
    for r in res["stem"] + res["dp"]:
        assert r["layout"] == (2, 1)
        for k in METRICS:
            np.testing.assert_allclose(r["metrics"][0][k], want[k],
                                       rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(r["metrics"][0][k], jax_metrics[k],
                                       rtol=1e-4, err_msg=f"JAX {k}")


def test_dryrun_multichip_four_ranks_runs_the_tensor_parallel_leg():
    """``dryrun_multichip(4)``: data 2 x model 2, as the JAX dry run lays
    four devices out; rank 0 prints the mesh with ``'model': 2`` and the
    decode leg's lengths."""
    code = ("from avsr_tpu_torch.dryrun import dryrun_multichip; "
            "dryrun_multichip(4)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()[-2:]
    assert re.fullmatch(r"dryrun_multichip\(4\): mesh=\{'data': 2, "
                        r"'model': 2\} loss=\d+\.\d{4} grad_norm=\d+\.\d{4}",
                        lines[0]), lines
    assert re.fullmatch(r"dryrun_multichip\(4\): decode mesh=\{'data': 4, "
                        r"'model': 1\} beam decode ok \(lens=\[\d+, \d+, "
                        r"\d+, \d+\]\)", lines[1]), lines


def test_model_size_must_cover_the_world():
    """``dist.set_layout`` names both sizes when their product is not the
    world's; a block without a tensor-parallel forward refuses to be
    sliced."""
    from avsr_tpu_torch.core import dist

    with pytest.raises(ValueError, match="data_parallel=1 x "
                                         "model_parallel=2"):
        dist.set_layout(1, 2)
    lin = torch.nn.Sequential()
    lin.add_module("fc1", torch.nn.Linear(4, 4))
    with pytest.raises(NotImplementedError, match="fc1.weight"):
        tp.shard_model_(lin, 0, 2)
    assert (dist.data_size(), dist.model_size()) == (1, 1)
