"""The port's training CLI (``avsr_tpu_torch/cli/train.py``) on the CPU:
its parser against the JAX CLI's, an end-to-end run in a fresh process
that never loads JAX, and the default device's failure without a card
(what it stands on: ``tests/test_torch_port_data.py``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_parser_matches_jax():
    """Every flag and default of the JAX CLI's parser, plus --device
    (cuda by default)."""
    from avsr_tpu.cli.train import build_parser as jparser
    from avsr_tpu_torch.cli.train import build_parser as pparser

    want = vars(jparser().parse_args([]))
    got = vars(pparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    jopts = {a.dest: a.choices for a in jparser()._actions}
    popts = {a.dest: a.choices for a in pparser()._actions}
    popts.pop("device")
    assert popts == jopts


CLI_SCRIPT = r"""
import os, sys, torch
sys.path.insert(0, {repo!r})
root = {root!r}
from chip_smoke import write_toy_tokenizer
from tests.torch_port_common import tiny_port_cfg
from avsr_tpu_torch.core.weights import init_weights
from avsr_tpu_torch.models.e2e import AVSRModel
torch.set_num_threads(2)
cfg = tiny_port_cfg()
os.makedirs(root + "/ckpt")
write_toy_tokenizer(os.environ["AVSR_SPM_DIR"], cfg.odim - 2)
m = AVSRModel(cfg)
init_weights(m, torch.Generator().manual_seed(0))
torch.save({{"avsr." + k: v for k, v in m.state_dict().items()}},
           root + "/ckpt/pytorch_model.bin")
cfg.to_json(root + "/ckpt/config.json")
from avsr_tpu_torch.cli import train
import avsr_tpu_torch.train.loop as loop
loop.T_BUCKETS = (8, 16)
import avsr_tpu_torch.data.dataset as ds
real = ds.synthetic_samples
ds.synthetic_samples = lambda n, seed=0: real(n, seed, 8, 14)
args = ["--device", "cpu", "--synthetic_dataset",
        "--model_name_or_path", root + "/ckpt", "--output_dir", root + "/out",
        "--batch_size", "1", "--gradient_accumulation_steps", "2",
        "--save_steps", "1", "--eval_steps", "2", "--log_interval", "1",
        "--warmup_steps", "1", "--dataloader_num_workers", "1",
        "--save_total_limit", "1"]
st = train.main(args + ["--max_steps", "2"])
assert st.step == 2, st.step
st = train.main(args + ["--max_steps", "3", "--resume_from_checkpoint"])
assert st.step == 3, st.step
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "avsr_tpu", "flax",
                                    "ml_dtypes"))
print("LOADED", bad)
"""


def test_cli_end_to_end_on_cpu(tmp_path):
    """``cli/train.main`` in a fresh process on a tiny reference-format
    directory with the toy tokenizer: 2 steps (--device cpu,
    --synthetic_dataset, 2 micro-batches a step, a checkpoint each step,
    keep 1, eval at step 2), then --resume_from_checkpoint to step 3; the
    process never loads JAX, avsr_tpu, flax or ml_dtypes."""
    env = dict(os.environ, AVSR_SPM_DIR=str(tmp_path / "spm"),
               PYTHONPATH=REPO)
    os.makedirs(env["AVSR_SPM_DIR"])
    out = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT.format(repo=REPO,
                                                 root=str(tmp_path))],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
    assert "Loading pretrained model from" in out.stdout
    assert "[eval step 2]" in out.stdout
    assert "Resuming from" in out.stdout and "[train step 3]" in out.stdout
    root = tmp_path / "out" / "avsr_avhubert_ctcattn" / "checkpoints"
    assert sorted(os.listdir(root)) == ["3", "best.json"]
    with open(root / "best.json") as f:
        assert json.load(f)["step"] == 2


def test_cli_default_device_fails_without_a_card():
    """No fallback: with no card, the default --device cuda exits with a
    message instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "avsr_tpu_torch.cli.train",
         "--synthetic_dataset", "--max_steps", "1"],
        capture_output=True, text=True, timeout=60, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
