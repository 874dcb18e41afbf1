"""Score -> ABC text export.

The port's copy of ``inpaintnet_tpu/data/abc_writer.py``, numpy only: the two must
give the same bytes.

Completes the I/O surface (the reference exports only MIDI from its
scripts; score text had to go through music21). Output conventions chosen
for unambiguous machine round-tripping through this framework's own
parser (tests enforce ``parse_abc(write_abc(score)) == score``):

- ``K:C`` with an EXPLICIT accidental (^/_/=) on every note, so measure
  accidental-persistence can never change a reading;
- ``L:1/8`` with exact fractional multipliers (``2/3`` for triplet
  quarters etc.) instead of tuplet brackets — valid ABC, exact durations;
- one bar per ``|``, 4 bars per line.
"""
from __future__ import annotations

from fractions import Fraction
from typing import List

from inpaintnet_tpu_torch.data.score import Pitch, Score

_UNIT_QL = Fraction(1, 2)  # L:1/8 in quarterLength


def _abc_pitch(p: Pitch) -> str:
    acc = {2: "^^", 1: "^", 0: "=", -1: "_", -2: "__"}[p.alter]
    if p.octave >= 5:
        letter = p.step.lower()
        marks = "'" * (p.octave - 5)
    else:
        letter = p.step.upper()
        marks = "," * (4 - p.octave)
    return acc + letter + marks


def _abc_duration(dur: Fraction) -> str:
    units = dur / _UNIT_QL
    if units == 1:
        return ""
    if units.denominator == 1:
        return str(units.numerator)
    return f"{units.numerator}/{units.denominator}"


def write_abc(score: Score, title: str = "", index: int = 1) -> str:
    num, den = score.time_signature
    bar = score.beats_per_measure
    lines: List[str] = [
        f"X:{index}",
        f"T:{title or score.title or 'untitled'}",
        f"M:{num}/{den}",
        "L:1/8",
        "K:C",
    ]
    bars: List[str] = []
    current: List[str] = []
    bar_end = bar
    for n in score.notes:
        tok = ("z" if n.is_rest else _abc_pitch(n.pitch)) + _abc_duration(n.duration)
        current.append(tok)
        if n.end >= bar_end:
            bars.append(" ".join(current))
            current = []
            bar_end += bar
    if current:
        bars.append(" ".join(current))
    body_lines = [
        "|".join(bars[i : i + 4]) + ("|]" if i + 4 >= len(bars) else "|")
        for i in range(0, len(bars), 4)
    ]
    return "\n".join(lines + body_lines) + "\n"
