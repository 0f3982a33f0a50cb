"""The three other dense LM configs of the port (yi-9b, granite-34b,
qwen2-72b) against the JAX package, on the CPU: each config field for
field (full and reduced), and the reduced model in f32 with
JAX-initialized weights carried across by ``lm_params_from_jax``: the
full forward (naive attention), the prefill (chunked: the flash
kernel's plain version against JAX's jnp chunked loop) and 4 greedy
decode steps, fed each side's own greedy tokens, which must agree. Each
config exercises a layer llama3.2-1b does not: GQA at Dh 128 (yi), the
qkv bias (qwen2), LayerNorm + GELU + MQA (granite).

Tolerance rtol/atol 5e-4 on logits, the bound of
``tests/test_torch_transformer.py`` (f32 products summed in another
order). Also ``examples/torch_serve_lm.py``: a reduced config served on
the CPU, the MoE, VLM and audio archs too.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduced
from repro.models import build_model as jbuild
from repro.training.step import make_decode_step as jdecode_step
from repro.training.step import make_prefill_step as jprefill_step
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch.serve import make_prompts
from repro_torch.models import build_model as tbuild
from repro_torch.training.step import make_decode_step, make_prefill_step

TOL = dict(rtol=5e-4, atol=5e-4)
ARCHS = ("yi-9b", "granite-34b", "qwen2-72b")
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches(arch, reduced):
    j, t = jget(arch), tget(arch)
    if reduced:
        j, t = jreduced(j), treduced(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    cfg_j, cfg_t = jreduced(jget(arch)), treduced(tget(arch))
    jm = jbuild(cfg_j, compute_dtype=jnp.float32, attention_impl="chunked",
                remat=False)
    params, _ = jm.init_params(jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    own = tbuild(cfg_t, torch.float32, device="cpu").init(0)
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in tp.items()}

    # the full forward (naive attention)
    jn = jbuild(cfg_j, compute_dtype=jnp.float32, attention_impl="naive",
                remat=False)
    tn = tbuild(cfg_t, torch.float32, attention_impl="naive", device="cpu")
    toks = np.random.RandomState(1).randint(0, cfg_j.vocab_size, (2, 48))
    want, _, _ = jn.forward(params, jnp.asarray(toks), mode="train")
    got, _, _ = tn.forward(tp, torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # prefill (chunked) + 4 greedy decode steps
    tm = tbuild(cfg_t, torch.float32, attention_impl="chunked", device="cpu")
    b, prompt, steps = 2, 128, 4
    toks = make_prompts(cfg_t, b, prompt, seed=3)
    jcache, _ = jm.cache_shape(b, prompt + steps, jnp.float32)
    tcache, _ = tm.cache_shape(b, prompt + steps, torch.float32)
    jl, jcache = jprefill_step(jm)(params, jcache,
                                   {"tokens": jnp.asarray(toks)})
    tl, tcache = make_prefill_step(tm)(tp, tcache,
                                       {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(steps):
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jcache = jdecode_step(jm)(params, jcache, {
            "tokens": jt, "cache_index": jnp.int32(prompt + i)})
        tl, tcache = make_decode_step(tm)(tp, tcache, {
            "tokens": tt, "cache_index": prompt + i})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} decode step {i}")


def _serve_script():
    path = os.path.join(ROOT, "examples", "torch_serve_lm.py")
    spec = importlib.util.spec_from_file_location("torch_serve_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_script_runs_on_cpu(arch, capsys):
    res = _serve_script().main(["--arch", arch, "--batch", "2",
                                "--prompt-len", "16", "--decode-steps", "3",
                                "--device", "cpu"])
    assert res["generated"].shape == (2, 3)
    assert ((res["generated"] >= 0) & (res["generated"] < 512)).all()
    assert f"arch={arch} (reduced)" in capsys.readouterr().out


@pytest.mark.parametrize("arch,item", [("mixtral-8x7b", None),
                                       ("phi-3-vision-4.2b", "15.4"),
                                       ("whisper-tiny", "15.5")])
def test_serve_lm_script_names_the_roadmap_item(arch, item, capsys):
    """Every arch serves: mixtral-8x7b since the MoE family was ported
    (item 15.3), phi-3-vision-4.2b (with its patches) and whisper-tiny
    (with its frames) since items 15.4 and 15.5, which raised naming
    their item before."""
    res = _serve_script().main(["--arch", arch, "--batch", "2",
                                "--prompt-len", "16",
                                "--decode-steps", "3",
                                "--device", "cpu"])
    assert res["generated"].shape == (2, 3)
    assert ((res["generated"] >= 0) & (res["generated"] < 512)).all()
    assert f"arch={arch} (reduced)" in capsys.readouterr().out
