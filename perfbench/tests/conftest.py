"""Shared settings of the benchmark's CPU tests.  What belongs to one
configuration or one cell is a data file found by its name:
``tiny/<config>.json``, the tiny widths that replace the configuration's
keys in both the program and the reference, and ``readings/<cell>.json``,
the card's readings that the cell's limits of ``correct`` were set from."""
import json
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: small batches whose prompts cross the tiny chunk (16)
SMALL_TRAFFIC = dict(batch=4, prompt_tokens=[20, 70], new_tokens=[1, 5])


def _named(folder: str, name: str, what: str) -> dict:
    path = TESTS / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{what} of {name!r}: {path} is not there")
    return json.loads(path.read_text())


def tiny(config: str) -> dict:
    """The tiny CPU widths of configuration ``config``."""
    return _named("tiny", config, "the tiny widths")


def card_readings(cell: str) -> dict:
    """The card's readings of cell ``cell``, at its own size: for each
    number its limit compares, ``[lower, upper]``, the largest reading
    of the program over its sound seeds and the smallest of the
    control."""
    return _named("readings", cell, "the card's readings")["readings"]
