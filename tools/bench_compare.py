"""Compare two bench.py JSON records row by row.

Usage: python tools/bench_compare.py A.json B.json [--tol 0.15]

Prints every NUMERIC row whose relative difference exceeds the
tolerance, and a summary. Boolean gates must be identical. Rows whose
absolute values are tiny (< 0.05 ms-scale) are compared with an
absolute floor so rows below the timing noise don't spuriously fail.
"""

import argparse
import json
import sys


def compare(a: dict, b: dict, tol: float = 0.15, abs_floor: float = 0.05):
    """Return (numeric_violations, bool_violations, n_compared)."""
    num_bad, bool_bad, n = [], [], 0
    for k in sorted(set(a) & set(b)):
        va, vb = a[k], b[k]
        if isinstance(va, bool) or isinstance(vb, bool):
            n += 1
            if va != vb:
                bool_bad.append((k, va, vb))
            continue
        if not (isinstance(va, (int, float))
                and isinstance(vb, (int, float))):
            continue
        n += 1
        denom = max(abs(va), abs(vb))
        if denom <= abs_floor:
            continue
        rel = abs(va - vb) / denom
        if rel > tol:
            num_bad.append((k, va, vb, rel))
    return num_bad, bool_bad, n


def main():
    p = argparse.ArgumentParser()
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--tol", type=float, default=0.15)
    args = p.parse_args()
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    num_bad, bool_bad, n = compare(a, b, tol=args.tol)
    for k, va, vb, rel in num_bad:
        print(f"DRIFT {k}: {va} vs {vb}  ({rel * 100:.0f}%)")
    for k, va, vb in bool_bad:
        print(f"GATE FLIP {k}: {va} vs {vb}")
    print(f"compared {n} rows: {len(num_bad)} numeric over "
          f"{args.tol * 100:.0f}%, {len(bool_bad)} gate flips")
    sys.exit(1 if (num_bad or bool_bad) else 0)


if __name__ == "__main__":
    main()
