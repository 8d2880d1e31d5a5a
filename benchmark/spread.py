#!/usr/bin/env python3
"""Spreads of a cell's runs, as the bounds are set from them.

    python3 benchmark/spread.py RESULT_LINE_FILE...

Each file holds a run's standard output (its last line the result). Files
are grouped into sets by a ``set<k>`` part of their name; for each set
and metric: the median, the quartiles (``statistics.quantiles(n=4)``)
and their distance as a share of the median, then the widest over sets.
"""

import json
import re
import statistics
import sys
from collections import defaultdict


def main(paths) -> int:
    sets = defaultdict(lambda: defaultdict(list))
    for path in paths:
        line = open(path).read().strip().splitlines()[-1]
        result = json.loads(line)
        tag = re.search(r"set\w+?(?=_)", path)
        for name, m in result["metrics"].items():
            sets[tag.group(0) if tag else "all"][name].append(m["value"])
    widest = defaultdict(float)
    for tag, metrics in sorted(sets.items()):
        for name, values in sorted(metrics.items()):
            med = statistics.median(values)
            q1, _, q3 = statistics.quantiles(values, n=4)
            spread = (q3 - q1) / med
            widest[name] = max(widest[name], spread)
            print(f"{tag} {name}: n {len(values)} median {med!r} q1 {q1!r} q3 {q3!r} "
                  f"spread {spread:.4%} values {values}")
    for name, s in sorted(widest.items()):
        print(f"widest {name}: {s:.4%} (5x: {5 * s:.4%})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
