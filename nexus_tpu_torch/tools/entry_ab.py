"""The port's entry points against another checkout of the repository, in
turns, on the card.

    python3 -m nexus_tpu_torch.tools.entry_ab --other PATH [--phases serve infer train]
                                              [--rounds 1]

PATH is another checkout's root (for example ``git archive <commit>``
unpacked into the gitignored ``_parent/``). Each phase is one of
``chip_smoke.py``'s runs through ``run_template_runtime``: ``serve`` (the
32-request fused serve at Llama-3-8B, all 32 layers), ``infer`` (8 rows,
prompt 512, 64 new tokens) and ``train`` (Llama-3-8B widths, 4 layers,
B 2 x S 4096). Every run is a fresh process started in its checkout's root
(each builds and loads its own kernels, untimed), in turns: other, this,
this, other, ``--rounds`` times. Prints one JSON line with every run's
headline metric, the medians, the card's name and its power limit. Run
from this repository's root.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
# phase → (chip_smoke expression giving the spec, headline metric)
PHASES = {
    "serve": ("chip_smoke._serve_spec()", "tokens_per_sec"),
    "infer": ("chip_smoke.INFER_SPEC", "decode_tokens_per_sec"),
    "train": ("chip_smoke._train_spec(n_layers=4, steps=8)", "tokens_per_sec"),
}
_CHILD = """
import json, sys, torch
import chip_smoke
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
torch.backends.cuda.matmul.allow_tf32 = False
m = run_template_runtime({spec})
print("RESULT " + json.dumps({{k: v for k, v in m.items() if isinstance(v, (int, float))}}))
"""


def run_once(root: Path, phase: str) -> dict:
    """One phase in a fresh process started in checkout ``root``."""
    spec, _ = PHASES[phase]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _CHILD.format(spec=spec)], cwd=root, env=env,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{phase} in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--phases", nargs="+", default=["serve", "infer", "train"],
                    choices=sorted(PHASES))
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    roots = {"other": args.other.resolve(), "this": _ROOT}
    result = {}
    for phase in args.phases:
        metric = PHASES[phase][1]
        runs = {"other": [], "this": []}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                runs[side].append(run_once(roots[side], phase)[metric])
        result[phase] = {"metric": metric, **{f"{k}_runs": v for k, v in runs.items()},
                         **{f"{k}_median": statistics.median(v) for k, v in runs.items()}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"name_and_power_limit": smi, "other": str(args.other),
                      "phases": result}), flush=True)


if __name__ == "__main__":
    main()
