"""The CUDA compositor kernel against its plain PyTorch version, on a card.

Marked ``gpu``: each test skips when no CUDA card is visible. The file
imports nothing from the other test modules, so it runs on a machine with
the card alone: ``python -m pytest tests/test_torch_kernel_gpu.py -m gpu``.
Tolerances: relative error (max |kernel - plain| / max |plain|) 1e-4 for
f32 glimpses, 3e-2 for bf16 glimpses against f32 truth."""

import numpy as np
import pytest
import torch

from spair_pytorch_tpu_torch.ops.kernels import composite as K

BARS = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def inputs(seed, b, n, c, dev, gated):
    rng = np.random.RandomState(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype("f"),
                               device=dev)
    glimpses = (u(b, n, c, 14, 14), u(b, n, 1, 14, 14),
                u(b, n, 1, 14, 14, lo=0.01))
    boxes = torch.cat([u(b, n, 2, lo=0.05, hi=0.95),
                       u(b, n, 2, lo=0.05, hi=0.6)], -1).contiguous()
    gate = (u(b, n) > 0.5).float() if gated else None
    return glimpses, boxes, gate


def rel(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / \
        max(float(w.abs().max()) for w in want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("c", [1, 3, 6])
def test_kernel_matches_plain(cuda, dtype, gated, c):
    glimpses, boxes, gate = inputs(c, 3, 30, c, cuda, gated)
    before = K.composite_forward.launches
    with torch.no_grad():
        got = K.composite_forward(
            *(g.to(getattr(torch, dtype)) for g in glimpses), boxes,
            (64, 48), 64, pres_gate=gate, den_floor_n=40)
        torch.cuda.synchronize()
        want = K.composite_plain(*glimpses, boxes, (64, 48), pres_gate=gate,
                                 den_floor_n=40)
    assert K.composite_forward.launches == before + 1
    assert got[0].shape == (3, c, 64, 48) and got[1].shape == (3, 1, 64, 48)
    assert rel(got, want) < BARS[dtype]


@pytest.mark.gpu
def test_kernel_all_gated(cuda):
    glimpses, boxes, _ = inputs(0, 2, 9, 1, cuda, False)
    with torch.no_grad():
        num, den = K.composite_forward(*glimpses, boxes, (32, 32),
                                       pres_gate=torch.zeros(2, 9,
                                                             device=cuda))
    assert bool((num == 0).all())
    np.testing.assert_allclose(den.cpu().numpy(), 9e-9, rtol=1e-6)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    glimpses, boxes, _ = inputs(1, 2, 9, 1, cuda, False)
    with pytest.raises(ValueError, match="contiguous"):
        K.composite_forward(glimpses[0].transpose(3, 4), *glimpses[1:],
                            boxes, (32, 32))
    with pytest.raises(TypeError):
        K.composite_forward(glimpses[0].half(), *glimpses[1:], boxes,
                            (32, 32))
    with pytest.raises(ValueError, match="boxes"):
        K.composite_forward(*glimpses, boxes.double(), (32, 32))
