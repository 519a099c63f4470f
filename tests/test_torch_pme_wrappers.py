"""ops/pme3.py's stencil wrappers refuse what csrc/pme_stencil.cu does not
take (before any build or launch, so on the CPU), and Pme3 on CPU tensors
takes the dense plain version: no kernel launch is counted. The kernels
themselves are held to the plain version on the card by
tests/test_torch_pme_card.py."""
import pytest
import torch

from molchanica_tpu_torch import tracing
from molchanica_tpu_torch.ops import pme3

K = (8, 8, 8)


def _args(R=2, n=5, dtype=torch.float64):
    g = torch.Generator().manual_seed(0)
    x = torch.rand((R, n, 3), generator=g, dtype=dtype) * 10.0
    q = torch.randn((R, n), generator=g, dtype=dtype)
    box = torch.full((3,), 10.0, dtype=dtype)
    return x, q, box


@pytest.mark.parametrize("bad", ["x", "q", "box", "mesh", "replicas",
                                 "side"])
def test_wrappers_refuse_shapes(bad):
    x, q, box = _args()
    phi = torch.zeros((2,) + K, dtype=x.dtype)
    k = K
    if bad == "x":
        x = x[..., :2]
    elif bad == "q":
        q = q[:, :-1]
    elif bad == "box":
        box = box[:2]
    elif bad == "mesh":
        phi = phi[:, :-1]
    elif bad == "replicas":
        x, q = x[None], q[None]
    else:
        k = (8, 8, 5)
        phi = torch.zeros((2,) + k, dtype=x.dtype)
    with pytest.raises(ValueError, match="shapes"):
        if bad == "mesh":
            pme3.pme_gather_cuda(k, x, q, box, phi)
        else:
            pme3.pme_spread_cuda(k, x, q, box)
    with pytest.raises(ValueError, match="shapes"):
        pme3.pme_gather_cuda(k, x, q, box, phi)


def test_wrappers_refuse_dtypes_devices_and_grad():
    x, q, box = _args()
    phi = torch.zeros((2,) + K, dtype=x.dtype)
    with pytest.raises(ValueError, match="dtypes"):
        pme3.pme_spread_cuda(K, x, q.float(), box)
    with pytest.raises(ValueError, match="dtypes"):
        pme3.pme_gather_cuda(K, x.half(), q.half(), box, phi.half())
    with pytest.raises(ValueError, match="CUDA"):
        pme3.pme_spread_cuda(K, x, q, box)
    with pytest.raises(ValueError, match="CUDA"):
        pme3.pme_gather_cuda(K, x[0], q[0], box, phi[0])
    with torch.enable_grad(), pytest.raises(ValueError, match="gradient"):
        pme3.pme_gather_cuda(K, x.requires_grad_(True), q, box, phi)


def test_cpu_takes_the_plain_version():
    x, q, box = _args()
    pme = pme3.Pme3(K, 0.35, device="cpu", dtype=torch.float64)
    tracing.reset_counters("pme_")
    xg = x.clone().requires_grad_(True)
    e = pme.batched(xg, q, box)
    (gx,) = torch.autograd.grad(e.sum(), xg)
    e1, gx1 = pme.value_and_grad(x[1], q[1], box)
    assert tracing.counters("pme_") == {}
    torch.testing.assert_close(e[1], e1, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(gx[1], gx1, rtol=1e-12, atol=1e-12)


def test_box_terms_follow_the_box():
    """The influence function and the volume's factors are kept while the
    same box tensor comes back unmodified, and made anew for another box,
    for the same box changed in place, and under inference mode."""
    pme = pme3.Pme3(K, 0.35, device="cpu", dtype=torch.float64)
    box = torch.full((3,), 10.0, dtype=torch.float64)
    first = pme._box_terms(box)
    assert pme._box_terms(box) is first
    other = pme._box_terms(box.clone() * 1.01)
    assert other is not first
    torch.testing.assert_close(other[0], pme._infl(box * 1.01))
    box.mul_(1.01)
    changed = pme._box_terms(box)
    assert changed is not first and changed is not other
    torch.testing.assert_close(changed[1], 332.0637128 / (2.0 * box.prod()))
    with torch.inference_mode():
        b = torch.full((3,), 10.0, dtype=torch.float64)
        torch.testing.assert_close(pme._box_terms(b)[0], first[0])
