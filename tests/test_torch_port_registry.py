"""Reference class names (lighting-asr's ``lasr.…:Cls`` and
``torch.optim:Adam``) resolve in the port as they do in ``lasr_tpu``.

  - Every entry of ``lasr_tpu``'s ``REFERENCE_NAME_ALIASES`` but
    ``SPMTokenizer`` (not ported: it needs ``sentencepiece``) resolves
    through the port's ``dynamic_import`` to the port class at the same
    module path.
  - A reference-named ``opti_config`` block (``torch.optim:Adam`` with the
    reference ``WarmupScheduler``) builds through the port's
    ``build_optimizer``, and its first update equals ``lasr_tpu``'s on the
    same gradients within 1e-6.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from lasr_tpu.utils.registry import REFERENCE_NAME_ALIASES as JAX_ALIASES
from lasr_tpu_torch.train.optimizer import build_optimizer
from lasr_tpu_torch.utils.registry import dynamic_import

UNPORTED = ("lasr.data.tokenizer:SPMTokenizer",)


@pytest.mark.parametrize("name", sorted(set(JAX_ALIASES) - set(UNPORTED)))
def test_reference_name_resolves_to_the_port_class(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cls = dynamic_import(name)
    module, _, obj = JAX_ALIASES[name].partition(":")
    assert cls.__name__ == obj
    assert cls.__module__ == "lasr_tpu_torch" + module[len("lasr_tpu"):]


OPTI_CONFIG = {
    "name": "torch.optim:Adam",
    "kwargs": {"betas": [0.9, 0.98], "eps": 1e-9},
    "scheduler": {
        "name": "lasr.modules.optimizer.scheduler:WarmupScheduler",
        "kwargs": {"model_size": 320, "factor": 3, "warm_step": 25000,
                   "offset": 0}},
}


def test_reference_named_optimizer_block_steps_as_lasr_tpu():
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 3), (5,))]
    grads = [rng.standard_normal(p.shape).astype(np.float32)
             for p in params]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        update, schedule = build_optimizer(OPTI_CONFIG)
        tx, _ = jax_build_optimizer(OPTI_CONFIG)
    assert schedule is not None
    tp = [torch.from_numpy(p.copy()) for p in params]
    state = update.init(tp)
    update.step(tp, [torch.from_numpy(g) for g in grads], state)

    jp = [jnp.asarray(p) for p in params]
    upd, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(jp), jp)
    for got, p, u in zip(tp, jp, upd):
        np.testing.assert_allclose(got.numpy(), np.asarray(p + u), atol=1e-6,
                                   rtol=0)
    # the step moved the weights (the schedule's first rate is not 0)
    assert any(not np.array_equal(got.numpy(), p)
               for got, p in zip(tp, params))
