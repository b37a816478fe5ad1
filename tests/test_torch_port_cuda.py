"""The port's CUDA kernels vs their plain twins, on an NVIDIA GPU.

Marked ``cuda``; every test skips where torch sees no CUDA device. Imports
torch only, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import pytest
import torch

from avsr_tpu_torch.ops.kernels import decode_attention as pda
from avsr_tpu_torch.ops.kernels import flash_attention as pfa
from avsr_tpu_torch.ops.kernels import topk as ptk

pytestmark = pytest.mark.cuda
NEG = -1.0e30


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tt,d", [(100, 16), (384, 64)])
def test_flash_kernel_matches_plain(dev, dtype, tol, tt, d):
    g = _gen(tt)
    n = 6
    q, k, v = (torch.randn(n, tt, d, generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([tt, tt - 9, tt // 2, 1, tt, 7])
    bias = torch.where(torch.arange(tt)[None] < lens[:, None], 0.0, NEG)
    want, want_lse = pfa.flash_attention_plain(q, k, v, bias, d ** -0.5)
    got, lse = pfa.flash_attention_fwd(*(x.to(dev) for x in (q, k, v, bias)),
                                       d ** -0.5)
    torch.cuda.synchronize()
    assert (got.float().cpu() - want.float()).abs().max() <= tol
    assert (lse.cpu() - want_lse).abs().max() <= 1e-3


@pytest.mark.parametrize("pos", [0, 37, 63, 80])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,k,dh", [(3, 3, 64), (2, 5, 32), (1, 1, 128)])
def test_decode_kernel_matches_plain(dev, pos, dtype, tol, b, k, dh):
    g = _gen(pos)
    s_max, heads = 64, 4
    n, c = b * k, heads * dh
    q = torch.randn(n, c, generator=g).to(dtype)
    kv = torch.randn(n, s_max, 2 * c, generator=g).to(dtype)
    row = torch.randn(n, 2 * c, generator=g).to(dtype)
    anc = torch.randint(0, k, (s_max, b, k), generator=g)
    anc[min(pos, s_max - 1)] = torch.arange(k)
    valid = (torch.arange(s_max) <= pos)[:, None, None, None] & (
        anc[..., None] == torch.arange(k))
    bias = torch.where(valid.permute(1, 2, 0, 3), 0.0, NEG).contiguous()
    want, want_kv = pda.decode_attention_plain(pos, q, kv.clone(), bias, k,
                                               heads, row)
    kv_d = kv.to(dev)
    got, got_kv = pda.decode_attention(pos, q.to(dev), kv_d, bias.to(dev), k,
                                       heads, row.to(dev))
    torch.cuda.synchronize()
    assert got_kv is kv_d
    assert torch.equal(got_kv.cpu(), want_kv)  # the written row, bit-exact
    assert (got.float().cpu() - want.float()).abs().max() <= tol


@pytest.mark.parametrize("rows,v,k", [(24, 5049, 4), (8, 15, 3)])
def test_topk_kernel_matches_plain(dev, rows, v, k):
    x = torch.randn(rows, v, generator=_gen(v))
    x[:, v // 2] = x.amax(dim=1)  # ties with the row max
    x[1] = 0.25
    want_v, want_i = ptk.topk_plain(x, k)
    got_v, got_i = ptk.topk_lastdim(x.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu(), want_v)
