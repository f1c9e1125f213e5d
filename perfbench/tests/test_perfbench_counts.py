"""``perfbench/counts`` against ``FlopCounterMode`` over the reference's
own training step, at small48's shapes, in every inference order and both
compositing modes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import train_step_flops
from perfbench.reference import spair
from perfbench.reference.inputs import (digit_bank, init_weights,
                                        reference_model, scenes, step_noise)
from perfbench.tests.tiny import TINY

BASE = dict(TINY, inference_mode="independent",
            anchor_shape=[24, 24], object_shape=[14, 14])


@pytest.mark.parametrize("extra", [
    {},
    {"inference_mode": "wavefront"},
    {"inference_mode": "raster", "pres_gate_threshold": 0.01},
    {"render_mode": "ordered", "pres_gate_threshold": 0.01},
])
def test_counted_flops_equal_the_flop_counter_on_the_reference(extra):
    from perfbench.registry import Registry
    fields = {**Registry().config("paper128")["config"], **BASE, **extra}
    cfg = spair.Config(fields)
    model = reference_model(cfg, init_weights(cfg, 3, "cpu"), "cpu")
    gen = torch.Generator().manual_seed(1)
    x, _, _ = scenes(gen, torch.as_tensor(digit_bank()), 3, (48, 48), 1, 6)
    noise = step_noise(gen, 3, cfg)
    with FlopCounterMode(display=False) as counter:
        total, _ = spair.loss(model, cfg, x, noise, 0)
        total.backward()
    assert counter.get_total_flops() == train_step_flops(fields, 3)


def test_the_count_at_the_cells_shapes():
    from perfbench.registry import Registry
    reg = Registry()
    paper = dict(reg.config("paper128")["config"], batch_size=128)
    quality = dict(reg.config("quality")["config"], batch_size=32)
    assert train_step_flops(paper, 128) == 422798622720
    assert train_step_flops(quality, 32) == 192892895232
