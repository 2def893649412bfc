"""Print the port's dry-run records as a markdown table.

    python tools/dryrun_table.py [RECORDS_DIR] [--collectives]

``RECORDS_DIR`` holds the JSON records of ``python -m
repro_torch.launch.dryrun`` (default ``results/dryrun_torch``). One row a
cell; where the cell also has a ternary record (``--quant ternary``), a
column shows "bf16 / ternary". Bytes are GB (1e9): params, AdamW state,
cache, inputs, the peak of live bytes over the step, and each device's
argument bytes on the production meshes pod16x16 and pod2x16x16 (bf16).
Then whether the step fits the card, its FLOPs (K3's and K4's tallies
included), K3's and K4's shape-only calls and the trace's seconds.

``--collectives`` prints instead what a device sends over the links in
a step of each cell on both production meshes (``collectives``: GB by
kind under the ring formulas of ``launch.collective_analysis``, the
calls of each kind, the total; a ternary decode record a row of its
own), or the reason a cell has none.
"""
import json
import pathlib
import sys


def _gb(n):
    return f"{n / 1e9:,.2f}"


def _both(bf16, tern, fmt):
    """``bf16``'s value, and ``tern``'s after a slash where it differs."""
    if tern is None or fmt(tern) == fmt(bf16):
        return fmt(bf16)
    return f"{fmt(bf16)} / {fmt(tern)}"


def rows(records_dir):
    recs = {}
    for path in sorted(pathlib.Path(records_dir).glob("*.json")):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"], rec.get("quant"))] = rec
    out = []
    for (arch, shape, quant), rec in sorted(recs.items(),
                                            key=lambda kv: kv[0][:2]):
        if quant:
            continue
        tern = recs.get((arch, shape, "ternary"))
        bad = [r for r in (rec, tern) if r and r["status"] != "ok"]
        if bad:
            out.append(f"| {arch} {shape} | " + "; ".join(
                f"{r['status']}: {r.get('error')}" for r in bad) + " |")
            continue
        full, mem = rec["full"], rec["full"]["memory"]
        t = tern and tern["full"]
        k3 = (t or full)["k3"]["calls"]
        out.append("| " + " | ".join([
            f"{arch} {shape}",
            _both(mem["param_bytes"], t and t["memory"]["param_bytes"], _gb),
            _gb(mem["opt_bytes"]), _gb(mem["cache_bytes"]),
            _gb(mem["input_bytes"]),
            _both(mem["peak_bytes"], t and t["memory"]["peak_bytes"], _gb),
            _both(full["fits"], t and t["fits"],
                  lambda f: "yes" if f else "no"),
            f"{full['flops']:.4e}",
            f"{k3} / {full['k4']['calls']}",
            _both(rec["trace_s"], tern and tern["trace_s"], str),
            " / ".join(_gb(rec["meshes"][m]["argument_bytes"])
                       for m in ("pod16x16", "pod2x16x16")
                       if m in rec["meshes"]),
        ]) + " |")
    return out


KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


def collective_rows(records_dir):
    out = []
    for path in sorted(pathlib.Path(records_dir).glob("*.json")):
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            continue
        quant = f" {rec['quant']}" if rec.get("quant") else ""
        for mesh, m in sorted(rec["meshes"].items()):
            col = m.get("collectives", {"error": "not recorded"})
            head = f"| {rec['arch']} {rec['shape']}{quant} | {mesh} | "
            if "error" in col:
                out.append(head + f"{col['error'][:120]} ||||||")
                continue
            out.append(head + " | ".join(
                [f"{_gb(col['bytes_by_kind'].get(k, 0))} "
                 f"({col['count_by_kind'].get(k, 0)})" for k in KINDS]
                + [_gb(col["total_bytes"]),
                   _gb(m["argument_bytes"])]) + " |")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    collectives = "--collectives" in argv
    argv = [a for a in argv if a != "--collectives"]
    records = argv[0] if argv else "results/dryrun_torch"
    if collectives:
        print("| cell | mesh | all-gather GB (calls) | reduce-scatter GB "
              "(calls) | all-reduce GB (calls) | all-to-all GB (calls) "
              "| total GB a device a step | argument GB a device |")
        print("|---" * 8 + "|")
        for row in collective_rows(records):
            print(row)
        return
    print("| cell | params GB | AdamW GB | cache GB | inputs GB | peak GB "
          "| fits | FLOPs | K3 / K4 calls | trace s "
          "| GB a device (2 meshes) |")
    print("|---" * 11 + "|")
    for row in rows(records):
        print(row)


if __name__ == "__main__":
    main()
