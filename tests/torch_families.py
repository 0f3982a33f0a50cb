"""Helpers shared by the tests of the port's last four families
(``test_torch_vlm.py``, ``test_torch_ssm.py``, ``test_torch_whisper.py``):
the launchers' train setups at the reduced configs on the CPU, the JAX
launcher started from the port's weights, and the three-step
comparison."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.launch.train import build_train_setup as jsetup
from repro.models.common import unbox
from repro_torch import interop
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.launch import train as tlaunch

BATCH, SEQ, SPE = 2, 32, 4
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced model's small products run
    faster so, and the port's threads do not contend with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def opt():
    """The recipe of the LM train tests (no weight decay)."""
    return dict(kind="rmsprop_warmup", schedule="slow_start",
                base_lr_per_256=3e-3, beta_center=1.0, beta_period=1.0,
                weight_decay=0.0)


def port_setup(arch, **kw):
    """The port's ``build_train_setup`` of ``arch`` (reduced) on the
    CPU: batch 2 x 32 tokens, naive attention."""
    return tlaunch.build_train_setup(
        treduced(tget(arch)), global_batch=BATCH, seq_len=SEQ,
        opt_cfg=TOpt(**opt()), steps_per_epoch=SPE, device="cpu", **kw)


def jax_train_from(tp, monkeypatch, arch, model_cls):
    """The JAX launcher's setup of ``arch`` (reduced) starting from the
    port's weights ``tp``: its ``model_cls.init_params`` gives them (and
    the logical axes of an abstract trace, no draw)."""
    monkeypatch.setattr(model_cls, "init_params", lambda self, key: (
        jax.tree.map(jnp.asarray, interop.params_to_jax(tp)),
        unbox(jax.eval_shape(self.init, key))[1]))
    _, js, jstep, jdata, _, _ = jsetup(
        jreduced(jget(arch)), global_batch=BATCH, seq_len=SEQ,
        opt_cfg=JOpt(**opt()), steps_per_epoch=SPE)
    return js, jstep, jdata


def assert_three_steps_match(js, jstep, jdata, ts, tstep, tdata):
    """Three steps on each side: losses within rtol 2e-5, then the
    parameters within a relative norm of 2e-4."""
    for i in range(3):
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in
                              jdata.batch_at(i).items()})
        ts, tmet = tstep(ts, tdata.batch_at(i))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-5)
    jflat = interop.lm_params_from_jax(jax.tree.map(np.asarray,
                                                    js["params"]), "cpu")
    num = sum(float((ts["params"][k].double() - v.double()).square().sum())
              for k, v in jflat.items())
    den = sum(float(v.double().square().sum()) for v in jflat.values())
    assert (num / den) ** 0.5 < 2e-4


def jax_param_shapes(jm):
    """The JAX model's parameter names ("/" paths) and shapes, from an
    abstract trace of its init."""
    shapes = jax.eval_shape(lambda k: jm.init_params(k)[0],
                            jax.random.PRNGKey(0))
    return {"/".join(str(k.key) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def assert_round_trip(tree, tp):
    """``params_to_jax(lm_params_from_jax(tree))`` bitwise, no leaf of
    the port's ``tp`` taken for a conv weight."""
    back = interop.params_to_jax(interop.lm_params_from_jax(tree, "cpu"))
    flat, flat_back = interop._flatten(tree), interop._flatten(back)
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        assert np.array_equal(v, flat_back[k]), k
    assert not any(interop.is_conv_leaf(k) for k in tp)
