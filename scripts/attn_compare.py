#!/usr/bin/env python3
"""Time the attention kernels of several checkouts on one card, in turns.

    python3 scripts/attn_compare.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example a
parent commit unpacked with ``git archive`` into ``build/parent``). For
each, in the order given, one process with ``TREE/src`` first on its path
builds that tree's kernels and times them with CUDA events (the median of
20 runs of 10 back-to-back calls, over 10):

* ``flash_attention_bwd`` at Phi-4-mini-3.8B's training shape (B 2, H 24,
  Hkv 8, S 4,096, dh 128, causal, bf16), from the forward kernel's output
  and log-sum-exp;
* ``flash_attention`` at the Llama-3-8B prefill (B 8, H 32, Hkv 8, S 512,
  dh 128, causal, bf16), without the log-sum-exp (the serving call).

Give the trees as parent, change, change, parent to compare two versions
on one card. The card's name and power limit come first, then one JSON
line a tree. Exits with another code than 0 without a card.
"""
import json
import os
import subprocess
import sys

TRAIN = (2, 24, 8, 4096, 128)     # B, H, Hkv, S, dh
PREFILL = (8, 32, 8, 512, 128)
RUNS, REPEAT = 20, 10


def time_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEAT):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / REPEAT)
    return sorted(times)[len(times) // 2]


def measure(tree: str) -> dict:
    """The two kernels' times with the ``repro_torch`` of ``tree``."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def heads(B, H, Hkv, S, dh):
        return [torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, H, S, dh), (B, Hkv, S, dh),
                                          (B, Hkv, S, dh), (B, H, S, dh))]

    q, k, v, do = heads(*TRAIN)
    o, lse = tfa.flash_attention_cuda(q, k, v, True, with_lse=True)
    bwd = time_ms(torch, lambda: tfa.flash_attention_bwd_cuda(
        q, k, v, o, do, lse, True))
    del q, k, v, do, o, lse
    q, k, v, _ = heads(*PREFILL)
    fwd = time_ms(torch, lambda: tfa.flash_attention_cuda(q, k, v, True))
    return {"tree": tree, "module": tfa.__file__,
            "flash_attention_bwd_ms": bwd, "flash_attention_ms": fwd}


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--measure":
        print(json.dumps(measure(argv[2])), flush=True)
        return 0
    import torch
    if len(argv) < 2 or not torch.cuda.is_available():
        print(__doc__ if len(argv) < 2 else "no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv[1:]:
        src = os.path.join(os.path.abspath(tree), "src")
        env = dict(os.environ, PYTHONPATH=src)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--measure", tree], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
