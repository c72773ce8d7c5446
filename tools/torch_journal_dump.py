"""Inspect a master journal: per-kind counts, compaction chain, torn
tail (docs/DESIGN.md §37).

    python tools/torch_journal_dump.py /path/to/master.journal
    python tools/torch_journal_dump.py --validate /path/to/master.journal
    python tools/torch_journal_dump.py --datasets /path/to/master.journal

Prints one JSON document: the live segment's header state (schema
version, master epoch, compaction count, clean shutdown), per-kind
record counts, the forensic segment chain (``<path>.1`` newest ..
``.N``), and a torn-tail report (corrupt line count + whether the final
byte is a newline). ``--validate`` exits non-zero when the journal is
unreadable, from a FUTURE schema version, or has corruption beyond a
torn tail (more than one corrupt line). ``--datasets`` adds the
replayed per-dataset accounting — what a restarting master would
rehydrate: outstanding leases, consumed shards, completed count.

The port's copy of ``tools/journal_dump.py``, over
``dlrover_tpu_torch.master.journal``: it reads a journal either package
wrote.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _segment_chain(path: str):
    chain = []
    n = 1
    while True:
        seg = f"{path}.{n}"
        if not os.path.exists(seg):
            break
        chain.append({"path": seg, "bytes": os.path.getsize(seg)})
        n += 1
    return chain


def _tail_report(path: str) -> dict:
    try:
        size = os.path.getsize(path)
        if size == 0:
            return {"bytes": 0, "ends_with_newline": True, "torn": False}
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
        return {
            "bytes": size,
            "ends_with_newline": last == b"\n",
            # A missing trailing newline is the signature of a SIGKILL
            # mid-append; the next MasterJournal open repairs it.
            "torn": last != b"\n",
        }
    except OSError as e:
        return {"error": str(e)}


def dump(path: str, with_datasets: bool = False) -> dict:
    from dlrover_tpu_torch.master.journal import SCHEMA_VERSION, load_journal

    state = load_journal(path)
    out = {
        "path": path,
        "schema_version": state.schema_version,
        "reader_schema_version": SCHEMA_VERSION,
        "master_epoch": state.master_epoch,
        "compactions": state.compactions,
        "clean_shutdown": state.clean_shutdown,
        "records": state.records,
        "corrupt_lines": state.corrupt_lines,
        "kinds": dict(state.kinds),
        "segments": _segment_chain(path),
        "tail": _tail_report(path),
        "kv_keys": sorted(state.kv),
        "ckpt_step": state.ckpt_step,
        "plan_seq": state.plan_seq,
        "rdzv": {name: r.get("round") for name, r in state.rdzv.items()},
    }
    if with_datasets:
        out["datasets"] = {
            name: {
                "epoch": r.epoch,
                "completed": r.completed,
                "outstanding_leases": sorted(r.outstanding),
                "consumed_shards": len(r.consumed),
                "has_explicit_todo": r.base_todo is not None,
                "streaming": r.splitter_ckpt is not None,
            }
            for name, r in state.datasets.items()
        }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="master journal dump")
    parser.add_argument("journal", help="journal path (live segment)")
    parser.add_argument(
        "--validate", action="store_true",
        help="exit 1 on unreadable/future-schema/corrupt-beyond-torn-tail",
    )
    parser.add_argument(
        "--datasets", action="store_true",
        help="include replayed per-dataset accounting",
    )
    args = parser.parse_args(argv)
    if not os.path.exists(args.journal):
        print(f"no such journal: {args.journal}", file=sys.stderr)
        return 1
    try:
        out = dump(args.journal, with_datasets=args.datasets)
    except ValueError as e:
        # Future schema version refusal surfaces here.
        print(json.dumps({"path": args.journal, "error": str(e)}))
        return 1
    print(json.dumps(out, indent=2))
    if args.validate and out["corrupt_lines"] > 1:
        # One corrupt line is the expected SIGKILL torn tail; more means
        # real corruption.
        print(
            f"VALIDATE FAILED: {out['corrupt_lines']} corrupt lines",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
