"""ABC notation parser (native — replaces music21's ABC ingest).

The port's copy of ``inpaintnet_tpu/data/abc_parser.py``, numpy only: the two must
give the same bytes.

The reference parses The Session corpus through
``music21.converter.parse(fp, format='abc')`` plus ``expandRepeats()``
(``folk_data_helpers.py:351-364``). music21 is not a dependency of this
framework; this module implements the ABC subset present in the folk-rnn
cleaned Session dump (``sessions_data_clean.txt``): monophonic tunes,
headers X/T/M/L/K/R, notes with accidentals and octave marks, rests,
broken rhythm, tuplets, ties, slurs, gracenotes, one level of repeats with
first/second endings.

Output is the framework's :class:`~inpaintnet_tpu_torch.data.score.Score` IR in
exact ``Fraction`` quarter-note units.

Behavioural notes (chosen for parity with the reference pipeline):
- Tied notes stay *separate* note events (music21 keeps tied notes as
  distinct ``Note`` objects and the reference tokenizer re-articulates
  them, ``folk_dataset.py:122-138``).
- Grace notes are dropped (zero-duration events can't live on the tick
  grid; tunes with them are mostly filtered by the validity pass anyway).
- Chords ``[ceg]`` raise: the corpus validity filter excludes tunes with
  ``"`` chord symbols, and the pipeline is monophonic
  (``folk_data_helpers.py:532-542``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from inpaintnet_tpu_torch.data.score import Note, Pitch, Score


class AbcParseError(ValueError):
    pass


# Mode -> key-signature offset in fifths relative to the major key of the
# same tonic.
_MODE_FIFTHS = {
    "maj": 0, "ion": 0, "": 0,
    "mix": -1,
    "dor": -2,
    "min": -3, "aeo": -3, "m": -3,
    "phr": -4,
    "loc": -5,
    "lyd": 1,
}

# Fifths for major tonics.
_MAJOR_FIFTHS = {
    "C": 0, "G": 1, "D": 2, "A": 3, "E": 4, "B": 5, "F#": 6, "C#": 7,
    "F": -1, "BB": -2, "EB": -3, "AB": -4, "DB": -5, "GB": -6, "CB": -7,
}

_SHARP_ORDER = "FCGDAEB"
_FLAT_ORDER = "BEADGCF"


def key_signature_alters(key_field: str) -> Dict[str, int]:
    """Parse an ABC ``K:`` field into step-letter -> alteration."""
    s = key_field.strip()
    if not s or s.lower() in ("none",):
        return {}
    m = re.match(r"^([A-Ga-g])([#b♯♭]?)\s*(\w*)", s)
    if not m:
        return {}
    tonic = m.group(1).upper()
    acc = m.group(2)
    if acc in ("b", "♭"):
        tonic += "B"
    elif acc in ("#", "♯"):
        tonic += "#"
    mode_raw = m.group(3).lower()
    if mode_raw.startswith("major"):
        mode = "maj"
    elif mode_raw.startswith("minor"):
        mode = "min"
    else:
        mode = mode_raw[:3] if len(mode_raw) >= 3 else mode_raw
    if mode not in _MODE_FIFTHS:
        mode = "m" if mode_raw.startswith("m") else ""
    fifths = _MAJOR_FIFTHS.get(tonic)
    if fifths is None:
        raise AbcParseError(f"unsupported tonic in K:{key_field!r}")
    fifths += _MODE_FIFTHS[mode]
    alters: Dict[str, int] = {}
    if fifths > 0:
        for step in _SHARP_ORDER[:fifths]:
            alters[step] = 1
    elif fifths < 0:
        for step in _FLAT_ORDER[:-fifths]:
            alters[step] = -1
    return alters


def _parse_time_signature(m_field: str) -> Tuple[int, int]:
    s = m_field.strip()
    if s in ("C", "common"):
        return (4, 4)
    if s in ("C|", "cut"):
        return (2, 2)
    m = re.match(r"^(\d+)\s*/\s*(\d+)", s)
    if not m:
        raise AbcParseError(f"unsupported M:{m_field!r}")
    num, den = int(m.group(1)), int(m.group(2))
    if num <= 0 or den <= 0:
        raise AbcParseError(f"invalid time signature M:{m_field!r}")
    return (num, den)


@dataclass
class _Event:
    """A parsed note/rest before repeat expansion. Durations are stored in
    quarterLengths at parse time (the unit length L: can change mid-tune,
    so conversion cannot be deferred to materialization)."""

    pitch: Optional[Pitch]
    duration: Fraction
    tie: bool = False


@dataclass
class _Bar:
    events: List[_Event]
    # barline info *preceding the next bar*
    repeat_start: bool = False  # this bar starts a repeated section
    repeat_end: bool = False  # barline after this bar is :|
    ending: int = 0  # 1 or 2 if this bar begins a numbered ending
    section_end: bool = False  # || or |] after this bar


_NOTE_RE = re.compile(
    r"""
    (?P<acc>\^{1,2}|_{1,2}|=)?          # accidental
    (?P<step>[A-Ga-g])                  # step letter
    (?P<oct>[',]*)                      # octave marks
    (?P<dur>\d*(?:/\d*|/+)?|\d+/\d+)?   # duration
    (?P<tie>-?)                         # tie
    """,
    re.VERBOSE,
)
_REST_RE = re.compile(r"(?P<kind>[zx])(?P<dur>\d*(?:/\d*|/+)?|\d+/\d+)?")


def _parse_duration(tok: Optional[str]) -> Fraction:
    if not tok:
        return Fraction(1)
    if tok.startswith("/"):
        if set(tok) == {"/"}:
            return Fraction(1, 2 ** len(tok))
        return Fraction(1, int(tok[1:]))
    if "/" in tok:
        num, den = tok.split("/", 1)
        num = int(num) if num else 1
        if den == "":
            return Fraction(num, 2)
        if set(den) == {"/"}:
            return Fraction(num, 2 ** (len(den) + 0))
        return Fraction(num, int(den))
    return Fraction(int(tok))


def _abc_pitch(step: str, octave_marks: str, alter: Optional[int]) -> Pitch:
    octave = 4 if step.isupper() else 5
    for ch in octave_marks:
        octave += 1 if ch == "'" else -1
    return Pitch(step.upper(), alter or 0, octave)


class _BodyParser:
    def __init__(self, key_alters: Dict[str, int], unit: Fraction):
        self.key_alters = dict(key_alters)
        self.unit = unit
        self.bars: List[_Bar] = [_Bar(events=[])]
        self.measure_accidentals: Dict[Tuple[str, int], int] = {}
        self.broken: int = 0  # pending broken-rhythm shift (+ = prev dotted)
        self.tuplet_remaining = 0
        self.tuplet_factor = Fraction(1)

    # --- barline handling -------------------------------------------------
    def _new_bar(self, repeat_start=False, ending=0):
        if self.bars and not self.bars[-1].events and not self.bars[-1].ending:
            # reuse empty trailing bar (e.g. "|:" at tune start)
            self.bars[-1].repeat_start = self.bars[-1].repeat_start or repeat_start
            self.bars[-1].ending = self.bars[-1].ending or ending
        else:
            self.bars.append(_Bar(events=[], repeat_start=repeat_start, ending=ending))
        self.measure_accidentals = {}

    def handle_barline(self, tok: str):
        ends_repeat = tok.startswith(":")
        starts_repeat = tok.endswith(":")
        section_end = tok in ("||", "|]", "[|")
        if self.bars:
            self.bars[-1].repeat_end = self.bars[-1].repeat_end or ends_repeat
            self.bars[-1].section_end = self.bars[-1].section_end or section_end
        self._new_bar(repeat_start=starts_repeat)

    def handle_ending(self, num: int):
        # ending marker immediately after a barline applies to current bar
        if self.bars and not self.bars[-1].events:
            self.bars[-1].ending = num
        else:
            self._new_bar(ending=num)

    # --- notes -------------------------------------------------------------
    def _apply_length_mods(self, dur: Fraction) -> Fraction:
        if self.tuplet_remaining > 0:
            dur *= self.tuplet_factor
            self.tuplet_remaining -= 1
        if self.broken > 0:
            dur *= Fraction(2 ** abs(self.broken) * 2 - 1, 2 ** abs(self.broken))
            self.broken = 0
        elif self.broken < 0:
            dur *= Fraction(1, 2 ** abs(self.broken))
            self.broken = 0
        return dur

    def add_note(self, acc: Optional[str], step: str, octs: str, dur_tok: str, tie: bool):
        if acc:
            alter = {"^": 1, "^^": 2, "_": -1, "__": -2, "=": 0}[acc]
            self.measure_accidentals[(step.upper(), _abc_pitch(step, octs, 0).octave)] = alter
        else:
            key = (step.upper(), _abc_pitch(step, octs, 0).octave)
            if key in self.measure_accidentals:
                alter = self.measure_accidentals[key]
            else:
                alter = self.key_alters.get(step.upper(), 0)
        dur = self._apply_length_mods(_parse_duration(dur_tok)) * self.unit * 4
        self.bars[-1].events.append(_Event(_abc_pitch(step, octs, alter), dur, tie))

    def add_rest(self, dur_tok: str):
        dur = self._apply_length_mods(_parse_duration(dur_tok)) * self.unit * 4
        self.bars[-1].events.append(_Event(None, dur))

    def set_broken(self, tok: str):
        # prev note dotted if '>', next note dotted if '<'
        n = len(tok)
        if tok[0] == ">":
            self._scale_prev(Fraction(2**n * 2 - 1, 2**n))
            self.broken = -n
        else:
            self._scale_prev(Fraction(1, 2**n))
            self.broken = n

    def _scale_prev(self, factor: Fraction):
        for bar in reversed(self.bars):
            if bar.events:
                bar.events[-1].duration *= factor
                return

    def start_tuplet(self, p: int, q: Optional[int], r: Optional[int], compound_meter: bool):
        if q is None:
            q = {2: 3, 3: 2, 4: 3, 6: 2, 8: 3}.get(p, 3 if compound_meter else 2)
        self.tuplet_factor = Fraction(q, p)
        self.tuplet_remaining = r if r is not None else p


def _expand_repeats(bars: List[_Bar]) -> List[_Bar]:
    """Linear one-level repeat expansion with 1st/2nd endings.

    Equivalent to music21 ``expandRepeats`` for the single-level structures
    in the folk corpus: a repeated section spans from the last ``|:`` (or
    section start) to ``:|``; a bar marked ``[1`` is skipped on the second
    pass; ``[2`` only plays on the second pass.
    """
    out: List[_Bar] = []
    repeat_start = 0  # index into `bars` where current section began
    i = 0
    pass_no = 1
    just_jumped = False  # arrived at repeat_start via the jump-back?
    while i < len(bars):
        bar = bars[i]
        if bar.repeat_start and not just_jumped:
            # a new ``|:`` ALWAYS starts a fresh section on pass 1 —
            # reaching it with pass_no still 2 happens when the previous
            # section's second ending finished on a plain barline (no
            # :| or |]); without the reset, this section's [1 ending is
            # skipped and its repeat never taken
            repeat_start = i
            pass_no = 1
        just_jumped = False
        if bar.ending and bar.ending != pass_no:
            # skip this ending's bars until repeat_end (for [1 on pass 2
            # this should not occur since we jump past it; for [2 on pass 1
            # skip until its repeat end or section end)
            while i < len(bars):
                if bars[i].repeat_end or bars[i].section_end:
                    i += 1
                    break
                i += 1
            continue
        out.append(bar)
        if bar.repeat_end:
            if pass_no == 1:
                i = repeat_start
                pass_no = 2
                just_jumped = True
                continue
            else:
                pass_no = 1
                i += 1
                repeat_start = i
                continue
        if bar.section_end:
            pass_no = 1
            repeat_start = i + 1
        i += 1
    return out


_INLINE_FIELD_RE = re.compile(r"\[([A-Za-z]):([^\]]*)\]")
_TUPLET_RE = re.compile(r"\((\d)(?::(\d)?)?(?::(\d)?)?")
_BARLINE_RE = re.compile(r"::|:\|\]?|\|\|:?|\[\||\|\]|\|:|\|")
_ENDING_RE = re.compile(r"\[([12])|\|([12])")


def parse_abc(text: str, expand_repeats: bool = True,
              return_both: bool = False):
    """Parse an ABC tune body into a :class:`Score`.

    :param text: full tune text including headers
    :param expand_repeats: expand ``|: :|`` and numbered endings (the
        reference always expands for the training pipeline).
    :param return_both: return ``(unexpanded, expanded)`` from ONE
        tokenization pass — the validity filter needs both views and
        tokenizing twice doubled the cold corpus-scan cost.
    """
    headers: Dict[str, str] = {}
    body_lines: List[str] = []
    in_body = False
    for raw in text.splitlines():
        line = raw.split("%", 1)[0].rstrip()
        if not line:
            continue
        m = re.match(r"^([A-Za-z]):(.*)$", line)
        if (m and in_body and m.group(1) not in "wW"
                and m.group(2).lstrip().startswith("|")):
            # a MUSIC line like 'E:| ...' — one note completing a bar at
            # line start before a repeat-end — not an info field
            m = None
        if m and (not in_body or m.group(1) in "KLMV"):
            key, val = m.group(1), m.group(2).strip()
            if key == "w":
                continue
            if in_body:
                # mid-tune K:/M:/L: lines change state from that point on
                # (like music21's mid-stream TimeSignature/KeySignature
                # objects); the HEADER values stay first-wins so the
                # score-level time signature is the opening one. V: voice
                # markers are ignored here — multi-voice tunes are dropped
                # by the corpus validity filter (folk_data_helpers.py:
                # 544-560), matching the reference.
                if key in ("M", "L", "K"):
                    if body_lines:
                        body_lines.append(f"[{key}:{val}]")
                    else:  # field between K: and the first music line
                        headers[key] = val
                continue
            headers[key] = val
            if key == "K":
                in_body = True
            continue
        if m and in_body:
            # other info lines inside the body (W: lyrics, N: notes, ...)
            # must never be read as note letters
            continue
        if in_body:
            body_lines.append(line)

    if "K" not in headers:
        raise AbcParseError("missing K: header")
    time_sig = _parse_time_signature(headers.get("M", "4/4"))
    if "L" in headers:
        unit = Fraction(headers["L"].replace(" ", ""))
    else:
        unit = Fraction(1, 16) if Fraction(*time_sig) < Fraction(3, 4) else Fraction(1, 8)

    key_alters = key_signature_alters(headers["K"])
    initial_time_sig = time_sig  # Score-level signature = the opening one
    num, den = time_sig
    compound = num in (6, 9, 12) and den == 8
    parser = _BodyParser(key_alters, unit)

    body = " ".join(body_lines)
    i = 0
    n = len(body)
    while i < n:
        ch = body[i]
        if ch in " \t\\\n":
            i += 1
            continue
        # inline fields [K:...] [M:...] [L:...]
        if ch == "[":
            m = _INLINE_FIELD_RE.match(body, i)
            if m:
                k, v = m.group(1), m.group(2)
                if k == "K":
                    parser.key_alters = key_signature_alters(v)
                elif k == "L":
                    parser.unit = Fraction(v.replace(" ", ""))
                elif k == "M":
                    # affects subsequent full-bar rests only; the
                    # score-level signature stays the opening one
                    num, den = _parse_time_signature(v)
                i = m.end()
                continue
            m = _ENDING_RE.match(body, i)
            if m and m.group(1):
                parser.handle_ending(int(m.group(1)))
                i = m.end()
                continue
            m = _BARLINE_RE.match(body, i)
            if m:  # the '[|' thick-thin barline (valid ABC)
                parser.handle_barline(m.group(0))
                i = m.end()
                continue
            raise AbcParseError(f"chords/unsupported '[' construct at {i}: {body[i:i+12]!r}")
        # barlines (check |1 |2 endings first)
        if ch in ":|":
            m = _ENDING_RE.match(body, i)
            if m and m.group(2):
                parser.handle_barline("|")
                parser.handle_ending(int(m.group(2)))
                i = m.end()
                continue
            m = _BARLINE_RE.match(body, i)
            if m:
                parser.handle_barline(m.group(0))
                i = m.end()
                continue
        # tuplets
        if ch == "(":
            m = _TUPLET_RE.match(body, i)
            if m:
                parser.start_tuplet(
                    int(m.group(1)),
                    int(m.group(2)) if m.group(2) else None,
                    int(m.group(3)) if m.group(3) else None,
                    compound,
                )
                i = m.end()
                continue
            i += 1  # slur open — ignore
            continue
        if ch == ")":
            i += 1
            continue
        # broken rhythm
        if ch in "<>":
            j = i
            while j < n and body[j] == ch:
                j += 1
            parser.set_broken(body[i:j])
            i = j
            continue
        # grace notes: drop
        if ch == "{":
            j = body.find("}", i)
            i = (j + 1) if j >= 0 else n
            continue
        # decorations
        if ch == "!":
            j = body.find("!", i + 1)
            i = (j + 1) if j >= 0 else i + 1
            continue
        if ch in "~.HLMOPSTuv":
            i += 1
            continue
        # rests
        m = _REST_RE.match(body, i)
        if m and ch in "zx":
            parser.add_rest(m.group("dur") or "")
            i = m.end()
            continue
        if ch == "Z":  # multi-measure rest
            m2 = re.match(r"Z(\d*)", body[i:])
            count = int(m2.group(1)) if m2.group(1) else 1
            bar_ql = Fraction(num * 4, den)
            for _ in range(count):
                parser.add_rest("")
                parser.bars[-1].events[-1].duration = bar_ql
                parser.handle_barline("|")
            i += m2.end()
            continue
        # notes
        m = _NOTE_RE.match(body, i)
        if m and m.group("step"):
            parser.add_note(
                m.group("acc"),
                m.group("step"),
                m.group("oct"),
                m.group("dur") or "",
                bool(m.group("tie")),
            )
            i = m.end()
            continue
        if ch == '"':
            raise AbcParseError("chord symbols not supported (filtered upstream)")
        # unknown char: skip defensively
        i += 1

    bars = [b for b in parser.bars if b.events]

    def materialize(bs: List[_Bar]) -> Score:
        # quarter-note offsets, recording written-bar durations
        notes: List[Note] = []
        bar_durations: List[Fraction] = []
        offset = Fraction(0)
        for bar in bs:
            bar_start = offset
            for ev in bar.events:
                dur = ev.duration  # already in quarterLengths
                if dur <= 0:
                    raise AbcParseError("zero or negative note duration")
                notes.append(Note(offset, dur, ev.pitch, ev.tie))
                offset += dur
            bar_durations.append(offset - bar_start)
        return Score(
            notes=notes,
            time_signature=initial_time_sig,
            title=headers.get("T", ""),
            bar_durations=bar_durations,
        )

    if return_both:
        return materialize(bars), materialize(_expand_repeats(bars))
    if expand_repeats:
        bars = _expand_repeats(bars)
    return materialize(bars)
