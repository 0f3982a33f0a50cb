"""Train a ~100M-parameter llama-style LM on the PyTorch port for a few
hundred steps on the synthetic token task with the paper's recipe,
with checkpoints and resume, as ``examples/train_llm_100m.py`` does
with the JAX package (f32, chunked attention: the flash kernel on the
card).

    PYTHONPATH=src python examples/torch_train_llm_100m.py --steps 200
    PYTHONPATH=src python examples/torch_train_llm_100m.py --steps 4 \
        --global-batch 2 --seq-len 128 --device cpu
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import OptimizerConfig, get_config  # noqa: E402
from repro_torch.launch.train import build_train_setup  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.training import LoopConfig, run_training  # noqa: E402


def lm_100m():
    """~100M params: llama3.2-style block at width 512."""
    base = get_config("llama3.2-1b")
    return dataclasses.replace(
        base, name="llama-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
        tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = lm_100m()
    opt_cfg = OptimizerConfig(kind="rmsprop_warmup", schedule="slow_start",
                              base_lr_per_256=3e-3,
                              beta_center=1.0, beta_period=1.0,
                              weight_decay=0.0)
    model, state, train_step, data, _, _ = build_train_setup(
        cfg, global_batch=args.global_batch, seq_len=args.seq_len,
        opt_cfg=opt_cfg, steps_per_epoch=50,
        compute_dtype=torch.float32, attention_impl="chunked",
        device=args.device)
    print(f"params: {count_params(state['params'])/1e6:.1f}M")

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="llm100m_ckpt_")
    result = run_training(
        train_step, state, data,
        LoopConfig(total_steps=args.steps, checkpoint_every=100,
                   checkpoint_dir=ckpt,
                   log_every=max(1, args.steps // 10)))
    for h in result.history:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"({h['time']*1e3:.0f} ms)")
    print(f"checkpoints: {ckpt} (resume by re-running with --ckpt-dir)")
    return result


if __name__ == "__main__":
    main()
