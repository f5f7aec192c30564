"""Phase 14 (a)-(c) of chip_smoke.py alone, with the device profile: DIS's
kernel dis_patch_search against its plain version at every scale of a
480 x 640 pair and at a portrait 1080p pair's finest scale, the card's DIS
against a CPU copy, and DIS timed at 1920 x 1080 and held to the plain
version at each of its scales, plus torch.profiler's device busy time a pair
and the kernel's share of it. Needs one CUDA card; about a minute and a
half, build included.

    python scripts/dis_probe.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dis_probe: no CUDA card")
    card = C.card_line()
    print(card, flush=True)
    out, entry, fail = C.dis_checks(card, profile=True)
    entry.pop("runs")
    print(json.dumps({"dis": out, "kernel": entry}))
    if fail:
        raise SystemExit("dis_probe: " + "; ".join(fail))


if __name__ == "__main__":
    main()
