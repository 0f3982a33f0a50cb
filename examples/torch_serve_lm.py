"""Serve a reduced LM on the PyTorch port with batched requests: prefill
+ greedy cached decode, as ``examples/serve_lm.py`` does with the JAX
package. Every LM arch of the registry: the dense family (llama3.2-1b,
yi-9b, granite-34b, qwen2-72b), the MoE family (mixtral-8x7b,
llama4-maverick-400b-a17b), phi-3-vision-4.2b (with random patches),
zamba2-7b, xlstm-350m and whisper-tiny (with random frames).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch yi-9b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2-72b \
        --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral-8x7b \
        --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-7b \
        --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="an LM arch id (reduced config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    res = serve(cfg, args.batch, args.prompt_len, args.decode_steps,
                device=args.device)
    print(f"arch={args.arch} (reduced) on {args.device}")
    print(f"prefill: {res['prefill_s']*1e3:8.1f} ms for "
          f"{args.batch}x{args.prompt_len} tokens")
    print(f"decode : {res['decode_tok_per_s']:8.1f} tok/s")
    for i, row in enumerate(res["generated"][:2]):
        print(f"  sample[{i}] tokens: {row[:10]}")
    return res


if __name__ == "__main__":
    main()
