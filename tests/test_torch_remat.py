"""Per-layer remat (``build_model(remat=True)``: each layer, or layer
group, checkpointed with ``torch.utils.checkpoint`` in training, as the
JAX package rematerializes its scan bodies) against the same model
without it, on the CPU: the loss and every parameter's gradient bitwise
equal, for a dense transformer, the hybrid (Mamba2 layers), xLSTM (the
mLSTM layers) and whisper (encoder and decoder layers), reduced, f32;
and a checkpointed forward leaves fewer tensors saved for the
backward."""
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.data import make_data
from repro_torch.models import build_model
from repro_torch.training.step import to_device

ARCHS = ["llama3.2-1b", "zamba2-7b", "xlstm-350m", "whisper-tiny"]


def _loss_and_grads(arch, remat):
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, compute_dtype=torch.float32,
                        attention_impl="naive", remat=remat, device="cpu")
    params, _ = model.init_params(0)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    data = make_data(cfg, ShapeConfig("train", 128, 2, "train"), seed=0)
    batch = to_device(data.batch_at(0), torch.device("cpu"))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        loss, _ = model.loss_fn(params, {}, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), sum(saved)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_and_saves_less(arch):
    loss0, g0, saved0 = _loss_and_grads(arch, False)
    loss1, g1, saved1 = _loss_and_grads(arch, True)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    assert not differ, differ[:5]
    assert saved1 < saved0, (saved1, saved0)
