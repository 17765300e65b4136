"""The port's CUDA kernels against their plain versions on the card. Marked
`cuda`: they skip where there is no NVIDIA GPU (the kernels are built for
sm_90a with nvcc at first use). Run on a Hopper machine with
`python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda`."""

import numpy as np
import pytest
import torch

from eagle_tpu_torch.ops import attn_kernels as ak
from eagle_tpu_torch.ops.kv_cache import compact_rows_plain
from eagle_tpu_torch.ops.tree import ancestor_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: one bf16 ulp (2**-7 relative) against the plain bf16 output, half an
# ulp against the plain version's f32 output before its cast; the atol covers
# the order of f32 sums on outputs near zero
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-5, atol=1e-5)),
    (torch.bfloat16, dict(rtol=2.0 ** -7, atol=1e-5))])
@pytest.mark.parametrize("start", [0, 1, 777, 2048])
def test_tree_attention_kernel(dev, dtype, tol, start):
    g = torch.Generator(device=dev).manual_seed(start)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(start)
    parents = torch.tensor([0] + [int(rng.integers(0, i)) for i in range(1, 61)],
                           device=dev)
    args = (r(61, 32, 128), r(8, 2176, 128), r(8, 2176, 128), r(61, 8, 128),
            r(61, 8, 128), ancestor_mask(parents, 61).contiguous())
    st = torch.tensor(start, device=dev)
    before = ak.LAUNCHES["tree_attention"]
    got = ak.tree_attention(*args, st)
    torch.testing.assert_close(got, ak.tree_attention_ref(*args, st), **tol)
    if dtype == torch.bfloat16:
        ref32 = ak.tree_attention_ref(*(a.float() if a.is_floating_point() else a
                                        for a in args), st)
        torch.testing.assert_close(got.float(), ref32, rtol=2.0 ** -8, atol=1e-5)
    assert ak.LAUNCHES["tree_attention"] == before + 1


def test_compact_rows_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((32, 1, 8, 2176, 128), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn_like(k)
    path = torch.tensor([0, 3, 7, 7, 7, 7, 7], device=dev)
    st = torch.tensor(1000, device=dev)
    k2, v2 = k.clone(), v.clone()
    ak.compact_rows(k, v, path, st)
    compact_rows_plain(k2, v2, path, st)
    assert torch.equal(k, k2) and torch.equal(v, v2)
