"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_port_*).

Weights come from the JAX side: the tiny config of ``tests/torch_ref.py``,
``model.init`` with ``PRNGKey(0)``, BN statistics randomised with numpy so
eval-mode BN is a real test, then ``flax_to_torch`` into the port.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def setup_torch():
    """fp32 on the CPU, no TF32, two threads (tier-1 runs six workers)."""
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


def port_model(cfg, variables):
    """The port's model with the JAX variables."""
    from avsr_tpu_torch.core.weights import torch_state_from_jax
    from avsr_tpu_torch.models.e2e import AVSRModel

    model = AVSRModel(cfg)
    model.load_state_dict(torch_state_from_jax(variables, cfg), strict=True)
    return model.eval()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))
