"""Forward throughput of this checkout against another one, alternately,
on one card.

    python -m ml_autofocusformermod_torch.compare_throughput OTHER_DIR \
        [--rounds 2] [--batch-size 128] [--cfg PRESET]

OTHER_DIR is a checkout of another commit (for example the parent, unpacked
with ``git archive``). Each round runs ``main --throughput`` (the preset
``--cfg`` of ``configs/``, by default AFF-Mini 224; bf16: 50 warm-up and 30
timed forwards) as a process of its own, in the
order other, this, this, other, so that both checkouts see the same card
and host. Prints one JSON line per run, then one with each side's img/s
and the ratio of their medians, then the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(root: str, batch: int, preset: str) -> float:
    cfg = os.path.join(root, "ml_autofocusformermod_torch", "configs",
                       preset)
    out = subprocess.run(
        [sys.executable, "-m", "ml_autofocusformermod_torch.main", "--cfg",
         cfg, "--device", "cuda", "--data-path", "no_dataset",
         "--throughput", "--batch-size", str(batch)],
        cwd=root, capture_output=True, text=True, check=True, timeout=900)
    for line in reversed(out.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)["throughput_img_s"]
    raise RuntimeError(f"no result from {root}:\n{out.stdout}\n{out.stderr}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--cfg", default="aff_mini.yaml",
                        help="a preset of configs/ (both checkouts need it)")
    args = parser.parse_args(argv)
    other = os.path.abspath(args.other)
    sides = {"other": [], "this": []}
    for r in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            fps = run(other if side == "other" else HERE, args.batch_size,
                      os.path.basename(args.cfg))
            sides[side].append(fps)
            print(json.dumps({"round": r, "side": side, "img_per_s": fps}),
                  flush=True)
    med = {k: statistics.median(v) for k, v in sides.items()}
    print(json.dumps({"this_img_per_s": sides["this"],
                      "other_img_per_s": sides["other"],
                      "median_this_over_other": med["this"] / med["other"]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
