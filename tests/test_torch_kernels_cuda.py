"""The splash CUDA kernels against their plain PyTorch version, on a card.

Skips without a CUDA card. Imports no JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from scal_sdt_tpu_torch.ops import splash as S


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 1024, 40), (1, 8, 1344, 40), (1, 4, 1100, 80),
                                   (1, 2, 1024, 64), (1, 2, 1030, 160)])
def test_kernels_match_reference_on_cuda(shape):
    """splash_attention (kernels, autograd) against autograd of the plain
    version, at the bounds of the JAX splash tests: forward 5e-3 max-abs,
    gradients 1.5e-2 relative."""
    if not torch.cuda.is_available():
        pytest.skip("the splash kernels run on a CUDA card only")
    r = np.random.RandomState(5)
    q, k, v, g = (torch.from_numpy(r.randn(*shape).astype(np.float32)).cuda().bfloat16()
                  for _ in range(4))
    scale = shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = S.splash_attention(*leaves, scale)
    want = S.splash_attention_reference(*refs, scale)
    out.backward(g)
    want.backward(g)
    assert float((out.float() - want.float()).abs().max()) < 5e-3
    for a, b in zip(leaves, refs):
        err = (a.grad.float() - b.grad.float()).abs().max() / b.grad.float().abs().max()
        assert float(err) < 1.5e-2
