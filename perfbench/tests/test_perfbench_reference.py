"""The frozen reference against the program's eager path on the CPU, on the
same weights and generator state: the reference never imports the program,
this test imports both."""

import numpy as np
import pytest
import torch

from perfbench.reference import spair
from perfbench.reference.inputs import PATCH_HW, digit_bank, init_weights
from perfbench.reference.runs import train_steps
from perfbench.tests.tiny import tiny_run


@pytest.mark.parametrize("cell,extra", [
    ("train.paper128.b128", {"compute_dtype": "float32"}),
    ("train.paper128.b128", {"compute_dtype": "float32",
                             "inference_mode": "independent"}),
    ("train.quality.b32", {"grad_clip_norm": 1e6, "render_topk": 8,
                           "min_scene_objects": 3,
                           "max_scene_objects": 5}),
])
def test_three_training_steps_agree_with_the_program(cell, extra):
    from spair_pytorch_tpu_torch.data import DataConfig
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from perfbench.common import program_config
    _, r, _ = tiny_run(cell, **extra)
    cfg = spair.Config(r.fields)
    weights = init_weights(cfg, r.seed, "cpu")
    state = create_train_state(program_config(r.fields), seed=r.seed,
                               device="cpu")
    state.model.load_state_dict(weights)
    first = r.traffic["first_step"]
    state.step.fill_(first)
    g0 = state.generator.get_state().clone()
    bank = torch.as_tensor(digit_bank())
    dcfg = DataConfig(image_hw=(48, 48), patch_hw=PATCH_HW,
                      min_objects=cfg.min_scene_objects,
                      max_objects=cfg.max_scene_objects)
    step = make_train_step(program_config(r.fields), datagen=(dcfg, bank))
    losses = []
    for i in range(3):
        state, m = step(state)
        losses.append(float(m["losses/total"]))
        if i == 0:
            grad1 = {k: state.optimizer.state[p]["exp_avg"] / 0.1
                     for k, p in state.model.named_parameters()}
    ref = train_steps(cfg, weights, g0, bank, cfg.batch_size, 3, "cpu",
                      first_step=first)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(grad1[k], ref["grad1"][k], rtol=1e-4,
                                   atol=1e-6 * float(ref["grad1"][k].abs()
                                                     .max()) + 1e-12)
        # Adam scales each element's step to about lr, so an element whose
        # gradient is near nought moves by a share of lr (or its sign) that
        # rounding decides: a ten-thousandth of the elements may differ,
        # and each leaf's change is held by its norm
        off = (p.detach() - ref["params"][k]).abs() > 2e-6
        assert int(off.sum()) <= 1e-4 * off.numel(), k
        got = torch.linalg.vector_norm(p.detach() - weights[k])
        want = torch.linalg.vector_norm(ref["params"][k] - weights[k])
        assert abs(float(got - want)) <= 1e-3 * float(want) + 1e-12, k
