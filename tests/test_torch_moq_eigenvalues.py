"""deepspeed_tpu_torch's MoQ eigenvalues, on the CPU: the power iteration
on losses of known Hessians (tests/test_quantize.py's cases), the engine's
per-layer quantize periods scaled by the converged eigenvalues against
the JAX engine's, and the refusal on the card. The schedule, the
quantizer, PLD, the Hessian-vector product and the per-layer eigenvalues
from JAX's start vectors are in tests/test_torch_moq.py, whose helpers
this file takes.
"""

import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
from test_torch_moq import MOQ, _config, _engines, _ids, _state


def test_power_iteration_quadratic():
    """tests/test_quantize.py:141: loss = 0.5 xᵀ A x has Hessian A."""
    A = torch.diag(torch.tensor([5.0, 2.0, 1.0]))
    x = torch.ones(3, requires_grad=True)
    ev = Eigenvalue(max_iter=200, tol=1e-5, stability=0.0, layer_name="x",
                    layer_num=1)
    lam = ev.compute_eigenvalue(lambda: 0.5 * x @ A @ x, [x],
                                generator=torch.Generator().manual_seed(0))
    assert abs(lam - 5.0) < 1e-2


def test_layerwise_eigenvalues():
    """tests/test_quantize.py:156: per-layer curvature aligned with the
    layer indices, the embeddings' sharper block kept out."""
    params = {"embeddings.e": torch.ones(4, requires_grad=True),
              "encoder.layer_0.w": torch.ones(4, requires_grad=True),
              "encoder.layer_1.w": torch.ones(4, requires_grad=True)}

    def loss():
        return 0.5 * (1.0 * (params["encoder.layer_0.w"] ** 2).sum()
                      + 3.0 * (params["encoder.layer_1.w"] ** 2).sum()
                      + 7.0 * (params["embeddings.e"] ** 2).sum())
    ev = Eigenvalue(max_iter=100, tol=1e-5, stability=0.0,
                    layer_name="encoder.layer", layer_num=2)
    tree = {"embeddings": {"e": 0}, "encoder": {"layer_0": {"w": 0},
                                                "layer_1": {"w": 0}}}
    assert [b[0] for b in ev.find_layer_blocks(tree)] == ["layer_0",
                                                          "layer_1"]
    lams = ev.compute_layer_eigenvalues(
        loss, params, generator=torch.Generator().manual_seed(0))
    assert abs(lams[0] - 1.0) < 1e-2 and abs(lams[1] - 3.0) < 1e-2


def test_engine_eigenvalue_periods_match_jax():
    """MoQ with eigenvalues on the CPU: per-layer periods scaled by the
    converged per-layer eigenvalues equal JAX's after each step (start
    vectors differ: JAX's PRNG, the port's generator)."""
    moq = dict(MOQ, quantize_bits={"start_bits": 12, "target_bits": 8},
               quantize_schedule={"quantize_period": 40,
                                  "schedule_offset": 0},
               eigenvalue={"enabled": True, "layer_num": 2,
                           "max_iter": 300, "tol": 1e-7})
    je, te = _engines(_config(quantize_training=moq))
    for i in range(2):
        batch = {"input_ids": _ids(seed=i)}
        assert float(te.train_batch(batch)) == pytest.approx(
            float(je.train_batch(batch)), rel=2e-5)
        assert _state(te.quantizer) == _state(je.quantizer), i
    assert te.quantizer.q_period != [40, 40]


def test_eigenvalue_on_cuda_raises_naming_roadmap(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    moq = dict(MOQ, eigenvalue={"enabled": True})
    with pytest.raises(NotImplementedError, match="Second derivatives"):
        dst.initialize(config=_config(quantize_training=moq),
                       model=tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny()),
                       device="cuda")
