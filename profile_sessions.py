#!/usr/bin/env python3
"""How often torch.profiler sessions on the card lose device events, over
``chip_smoke.py``'s per-call tables of phase 8.

    python3 profile_sessions.py [repetitions]   # default 20

Builds the kernels, then measures both tables (``kernels_per_launch``: six
sampler forms; ``train_kernels_per_launch``: the ordered bfloat16 sum and
four training forms) ``repetitions`` times in one process. Each row is
profiled until two sessions' traces agree kernel by kernel
(``chip_smoke.kept_session``), so a row that takes more than two sessions
had one that lost events. Prints one JSON line (the rows, the sessions, the
repetitions whose tables differ from the first), then one line for each
row that took more than two sessions: every session's trace as its
difference from the last one's. Needs one CUDA device."""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke


def record_traces() -> list:
    """Makes ``chip_smoke.kept_session`` append, for each profiled call, the
    trace of every session it took ({kernel name: device events}) to the
    list returned."""
    calls, kept_session = [], chip_smoke.kept_session

    def recording(session, held=None, sessions=chip_smoke.PROFILE_SESSIONS):
        traces = []

        def recorded():
            out = session()
            traces.append(out[0])
            return out

        calls.append(traces)
        return kept_session(recorded, held, sessions)

    chip_smoke.kept_session = recording
    return calls


def differences(traces: list) -> list:
    """Each trace as its difference from the last one, {kernel: events
    more (+) or fewer (−)}, names cut to 60 characters."""
    last = traces[-1]
    return [{name[:60]: t.get(name, 0) - last.get(name, 0)
             for name in sorted(set(t) | set(last)) if t.get(name, 0) != last.get(name, 0)}
            for t in traces[:-1]] + [{name[:60]: n for name, n in sorted(last.items())}]


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_sessions: no CUDA device visible", file=sys.stderr)
        return 1
    reps = int(argv[0]) if argv else 20
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    device = torch.device("cuda")
    calls = record_traces()
    t0 = time.perf_counter()
    tables, retaken = [], []
    sessions = kept = rows_seen = 0
    for rep in range(reps):
        first = len(calls)
        per_launch, rows = chip_smoke.kernels_per_launch(device)
        per_train_call, train_rows = chip_smoke.train_kernels_per_launch(device)
        tables.append({"per_launch": per_launch, "per_train_call": per_train_call})
        rows = {**rows, **{f"train {form}": row for form, row in train_rows.items()}}
        for (form, (n, ok)), traces in zip(rows.items(), calls[first:]):
            sessions += n
            kept += ok
            rows_seen += 1
            if n > 2 or not ok:
                retaken.append({"repetition": rep, "row": form, "sessions": n, "kept": ok,
                                "traces": differences(traces)})
    agree = [i for i, t in enumerate(tables) if t != tables[0]]
    print(json.dumps({
        "nvidia_smi": smi, "repetitions": reps, "rows": rows_seen, "kept": kept,
        "sessions": sessions, "tables_differing_from_the_first": agree,
        "table": tables[0], "seconds": time.perf_counter() - t0,
    }), flush=True)
    for row in retaken:
        print(json.dumps(row), flush=True)
    return 0 if not agree and kept == rows_seen else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
