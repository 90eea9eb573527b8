"""K1 (the strip emitter) at the dense path's K_AB shape with its output
rows padded to 16, 128, 256 and 512 bytes: the row pitch the wrapper
picks for a ragged N (``ops/cuda_affinity.ROW_BYTES``).

    python3 scripts/k1_rows.py [--rounds 2]

The operands are those of ``chip_smoke.k1_dense_cases``: the features of
bench.py's f32 twin of config 2 at 512x512 (``make_workload_dense``), 5243
sample rows against 256901 columns in permuted [A; B] order (N % 8 = 5).
Each pitch is timed by CUDA events over 10 launches after a warm-up, for
the f32 and the bf16 store, in turns over ``--rounds`` rounds; every
output must equal the wrapper's bit for bit.
Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PITCHES = (16, 128, 256, 512)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_rows: needs a CUDA card")
    import chip_smoke as cs
    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops.affinity import extract_features

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg, _, noisy, plan = cs.make_workload_dense(gt)
    perm = torch.as_tensor(plan.perm.astype("int64"), device=dev)
    fp = extract_features(torch.as_tensor(noisy, device=dev), cfg)[perm]
    fa, fb = fp[:plan.p].contiguous(), fp[plan.p:].contiguous()
    p, d = fa.shape
    n = fb.shape[0]
    lib = _build.lib()
    scratch = torch.empty(lib.glt_affinity_scratch_bytes(p, d),
                          dtype=torch.uint8, device=dev)
    times = {}
    for rnd in range(args.rounds):
        for dt in (torch.float32, torch.bfloat16):
            store = None if dt == torch.float32 else dt
            ref = k1.affinity_strip_cuda(fa, fb, torch.float32, store)
            for pitch in PITCHES:
                per = pitch // dt.itemsize
                ld = -(-n // per) * per
                out = torch.empty((p, ld), dtype=dt, device=dev)

                def launch():
                    _build.check(lib.glt_affinity_strip(
                        fa.data_ptr(), fb.data_ptr(), scratch.data_ptr(),
                        out.data_ptr(), p, n, d, ld, int(store is not None),
                        _build.stream_ptr(fa)), "k1_rows")

                ms = cs.cuda_ms(launch, 10)
                same = bool(torch.equal(out[:, :n], ref))
                print(f"round {rnd} {dt} rows {pitch} B (ld {ld}): "
                      f"{ms:.3f} ms; equal to the wrapper's: {same}",
                      flush=True)
                if not same:
                    sys.exit("k1_rows: a pitch changed the strip")
                times.setdefault(f"{str(dt)[6:]} {pitch}", []).append(ms)
                del out
            del ref
            torch.cuda.empty_cache()
    print(json.dumps(dict(card=card, shape=[p, n], row_bytes_shipped=
                          k1.ROW_BYTES, ms=times)), flush=True)


if __name__ == "__main__":
    main()
