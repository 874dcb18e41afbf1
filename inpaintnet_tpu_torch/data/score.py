"""Symbolic-score intermediate representation.

The port's copy of ``inpaintnet_tpu/data/score.py``, numpy only: the two must
give the same bytes.

The reference leans on music21 ``Score`` objects end-to-end (parsing,
transposition, tick checks: ``folk_data_helpers.py:47-121``,
``folk_dataset.py:81-142``). music21 is a heavyweight host-side dependency;
this framework replaces it with a minimal, exact IR: monophonic sequences of
(offset, duration, pitch) in quarter-note units, using ``fractions.Fraction``
so the 6-per-beat unequal tick grid (0, 1/4, 1/3, 1/2, 2/3, 3/4 —
``folk_data_helpers.py:22-29``) is represented without rounding error.

Pitch spelling follows music21 conventions ('#' sharp, '-' flat,
``nameWithOctave`` like 'B-4'), so token vocabularies are string-compatible
with reference ``index_dicts.txt`` files. Transposition is by "most natural
interval" per semitone count (``folk_dataset.py:175-187``), implemented with
proper diatonic letter arithmetic so spellings match interval transposition
rather than naive pitch-class math.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

# Diatonic steps and their pitch classes.
_STEPS = "CDEFGAB"
_STEP_PC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}

# Most natural interval for each semitone distance 0..12 as
# (generic_steps, semitones). Matches music21's
# convertSemitoneToSpecifierGeneric choices (P1 m2 M2 m3 M3 P4 d5 P5 m6 M6
# m7 M7 P8).
_SEMITONE_TO_GENERIC = {
    0: 0, 1: 1, 2: 1, 3: 2, 4: 2, 5: 3, 6: 4, 7: 4, 8: 5, 9: 5, 10: 6, 11: 6, 12: 7,
}


@dataclass(frozen=True)
class Pitch:
    """A spelled pitch: step letter, chromatic alteration, octave (scientific:
    C4 = middle C = MIDI 60)."""

    step: str
    alter: int
    octave: int

    @property
    def midi(self) -> int:
        return 12 * (self.octave + 1) + _STEP_PC[self.step] + self.alter

    @property
    def name(self) -> str:
        """music21-style nameWithOctave, e.g. 'C#4', 'B-4', 'F##5'."""
        if self.alter >= 0:
            acc = "#" * self.alter
        else:
            acc = "-" * (-self.alter)
        return f"{self.step}{acc}{self.octave}"

    @staticmethod
    def from_name(name: str) -> "Pitch":
        step = name[0].upper()
        i = 1
        alter = 0
        while i < len(name) and name[i] in "#-":
            alter += 1 if name[i] == "#" else -1
            i += 1
        octave = int(name[i:])
        return Pitch(step, alter, octave)

    def transpose(self, semitones: int) -> "Pitch":
        """Transpose by the most natural interval for ``semitones``."""
        if semitones == 0:
            return self
        sign = 1 if semitones > 0 else -1
        mag = abs(semitones)
        octaves, rem = divmod(mag, 12)
        generic = _SEMITONE_TO_GENERIC[rem] + 7 * octaves
        step_idx = _STEPS.index(self.step)
        new_idx_abs = step_idx + sign * generic
        new_step = _STEPS[new_idx_abs % 7]
        octave_shift = new_idx_abs // 7
        new_octave = self.octave + octave_shift
        target_midi = self.midi + semitones
        base_midi = 12 * (new_octave + 1) + _STEP_PC[new_step]
        return Pitch(new_step, target_midi - base_midi, new_octave)


@dataclass(frozen=True)
class Note:
    """A note or rest. ``pitch is None`` means rest. Offsets/durations in
    quarter-note units as exact Fractions."""

    offset: Fraction
    duration: Fraction
    pitch: Optional[Pitch] = None
    tie_to_next: bool = False

    @property
    def is_rest(self) -> bool:
        return self.pitch is None

    @property
    def is_note(self) -> bool:
        return self.pitch is not None

    @property
    def end(self) -> Fraction:
        return self.offset + self.duration


@dataclass
class Score:
    """A monophonic score: notes sorted by offset, plus a time signature."""

    notes: List[Note] = field(default_factory=list)
    time_signature: Tuple[int, int] = (4, 4)
    title: str = ""
    # Durations of the *written* bars (set by the parser). Needed because a
    # pick-up bar makes flattened offsets non-bar-aligned.
    bar_durations: Optional[List[Fraction]] = None

    @property
    def highest_time(self) -> Fraction:
        if not self.notes:
            return Fraction(0)
        return max(n.end for n in self.notes)

    @property
    def beats_per_measure(self) -> Fraction:
        num, den = self.time_signature
        return Fraction(num * 4, den)

    def pitches_midi(self) -> List[int]:
        return [n.pitch.midi for n in self.notes if n.is_note]

    def pitch_range(self) -> Tuple[int, int]:
        ps = self.pitches_midi()
        return min(ps), max(ps)

    def transpose(self, semitones: int) -> "Score":
        return Score(
            notes=[
                replace(n, pitch=n.pitch.transpose(semitones) if n.pitch else None)
                for n in self.notes
            ],
            time_signature=self.time_signature,
            title=self.title,
            bar_durations=self.bar_durations,
        )

    def fix_pick_up_measure(self) -> "Score":
        """Prepend a rest filling an anacrusis (pick-up) measure.

        Mirrors reference ``fix_pick_up_measure_offset``
        (folk_data_helpers.py:463-484): if the first written bar is
        incomplete and first+second bar together don't form exactly one
        measure, insert a leading rest of the missing duration and shift
        everything right.
        """
        if not self.notes:
            return self
        bar = self.beats_per_measure
        if self.bar_durations:
            m0_dur = self.bar_durations[0]
            m1_dur = (
                self.bar_durations[1] if len(self.bar_durations) > 1 else Fraction(0)
            )
        else:
            m0_dur = min(bar, self.highest_time)
            m1_dur = Fraction(0)
        if m0_dur >= bar:
            return self
        if m0_dur + m1_dur == bar:
            # reference leaves split-bar pairs alone
            return self
        pad = bar - m0_dur
        shifted = [replace(n, offset=n.offset + pad) for n in self.notes]
        new_bars = None
        if self.bar_durations:
            new_bars = [bar] + list(self.bar_durations[1:])
        return Score(
            [Note(Fraction(0), pad)] + shifted,
            self.time_signature,
            self.title,
            bar_durations=new_bars,
        )

    def fix_last_measure(self) -> "Score":
        """Append a rest completing the final measure (reference
        ``fix_last_measure``, folk_data_helpers.py:486-501)."""
        if not self.notes:
            return self
        bar = self.beats_per_measure
        end = self.highest_time
        rem = end % bar
        if rem == 0:
            return self
        pad = bar - rem
        new_bars = None
        if self.bar_durations:
            new_bars = list(self.bar_durations[:-1]) + [self.bar_durations[-1] + pad]
        return Score(
            list(self.notes) + [Note(end, pad)],
            self.time_signature,
            self.title,
            bar_durations=new_bars,
        )

    def on_ticks(self, tick_values: Sequence[Fraction]) -> bool:
        """True iff every note offset's fractional part is a grid tick
        (reference ``score_on_ticks``, folk_data_helpers.py:47-59)."""
        ticks = set(tick_values)
        return all((n.offset % 1) in ticks for n in self.notes)
