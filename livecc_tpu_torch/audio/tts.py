"""Self-contained formant-synthesis TTS: the render pipeline's offline default.

The port's copy of ``livecc_tpu/audio/tts.py`` (pure numpy; a test holds
its samples bit-equal to the original's). The reference's render step speaks
each commentary sentence through Kokoro (demo/render/video.py:37-49), an
external neural TTS that the package does not depend on. ``demo.render.
render_commentary_video`` keeps TTS pluggable (``tts(text) -> (samples,
rate)``); this module is a dependency-free default with the same contract:
rule-based grapheme->phoneme conversion and a Klatt-style source-filter
synthesizer (glottal pulse train + cascade formant resonators + fricative
noise). Robotic but intelligible, deterministic, and fast.

``synthesize(text)`` -> (float32 mono samples in [-1, 1], 16000).
"""

from __future__ import annotations

import re

import numpy as np

RATE = 16000

# Per-phoneme spec: (kind, duration_s, F1, F2, F3) for voiced sonorants;
# fricatives/stops carry filter hints instead. Formant targets are the
# classic Peterson–Barney style averages.
VOWELS = {
    "IY": (0.12, 270, 2290, 3010), "IH": (0.09, 390, 1990, 2550),
    "EH": (0.10, 530, 1840, 2480), "AE": (0.12, 660, 1720, 2410),
    "AA": (0.12, 730, 1090, 2440), "AO": (0.12, 570, 840, 2410),
    "UH": (0.09, 440, 1020, 2240), "UW": (0.12, 300, 870, 2240),
    "AH": (0.09, 640, 1190, 2390), "ER": (0.11, 490, 1350, 1690),
    "EY": (0.13, 480, 2100, 2700), "AY": (0.14, 660, 1500, 2500),
    "OW": (0.13, 500, 950, 2400), "AW": (0.14, 640, 1100, 2400),
    "OY": (0.14, 520, 1300, 2450),
}
NASALS = {"M": (0.07, 280, 1100, 2200), "N": (0.07, 320, 1450, 2300),
          "NG": (0.08, 300, 1300, 2300)}
LIQUIDS = {"L": (0.07, 360, 1100, 2600), "R": (0.08, 400, 1200, 1600),
           "W": (0.07, 320, 700, 2300), "Y": (0.07, 300, 2200, 2900)}
FRICATIVES = {  # (duration, center_freq, bandwidth, voiced)
    "S": (0.10, 5500, 3000, False), "SH": (0.10, 3200, 2200, False),
    "F": (0.09, 4500, 4000, False), "TH": (0.09, 5000, 4000, False),
    "HH": (0.07, 1500, 2000, False), "Z": (0.09, 5500, 3000, True),
    "ZH": (0.09, 3200, 2200, True), "V": (0.08, 4500, 4000, True),
    "DH": (0.07, 5000, 4000, True),
}
STOPS = {  # (closure_s, burst_center, voiced)
    "P": (0.05, 1200, False), "B": (0.04, 1200, True),
    "T": (0.05, 4000, False), "D": (0.04, 4000, True),
    "K": (0.05, 2500, False), "G": (0.04, 2500, True),
    "CH": (0.08, 3200, False), "JH": (0.07, 3200, True),
}

# Ordered grapheme -> phoneme rules (longest-match). A tiny letter-to-sound
# system, not a dictionary — enough for sports-commentary vocabulary.
G2P_RULES = [
    ("tion", ["SH", "AH", "N"]), ("ough", ["OW"]), ("igh", ["AY"]),
    ("sch", ["S", "K"]), ("tch", ["CH"]), ("dge", ["JH"]),
    ("ai", ["EY"]), ("ay", ["EY"]), ("ee", ["IY"]), ("ea", ["IY"]),
    ("oo", ["UW"]), ("ou", ["AW"]), ("ow", ["OW"]), ("oi", ["OY"]),
    ("oy", ["OY"]), ("au", ["AO"]), ("aw", ["AO"]), ("ar", ["AA", "R"]),
    ("or", ["AO", "R"]), ("er", ["ER"]), ("ir", ["ER"]), ("ur", ["ER"]),
    ("th", ["TH"]), ("sh", ["SH"]), ("ch", ["CH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("a", ["AE"]), ("e", ["EH"]), ("i", ["IH"]), ("o", ["AA"]),
    ("u", ["AH"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]), ("j", ["JH"]),
    ("k", ["K"]), ("l", ["L"]), ("m", ["M"]), ("n", ["N"]),
    ("p", ["P"]), ("r", ["R"]), ("s", ["S"]), ("t", ["T"]),
    ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]), ("y", ["Y"]),
    ("z", ["Z"]),
]


def text_to_phonemes(text: str) -> list[str]:
    """Rule-based longest-match letter-to-sound; words separated by pauses."""
    out: list[str] = []
    for word in re.findall(r"[a-z']+|[0-9]+|[.,!?;:]", text.lower()):
        if word[0].isdigit():
            for digit in word:
                out.extend(_DIGITS[digit] + ["pau"])
            continue
        if word in ".,!?;:":
            out.append("sil")
            continue
        word = word.replace("'", "")
        i = 0
        # final silent 'e' heuristic: "game" -> g-EY-m
        silent_e = len(word) > 2 and word.endswith("e") and word[-2] not in "aeiou"
        body = word[:-1] if silent_e else word
        while i < len(body):
            for pat, phones in G2P_RULES:
                if body.startswith(pat, i):
                    ph = list(phones)
                    # long-vowel flip before the silent e: a->EY, i->AY, o->OW
                    if (silent_e and i + len(pat) == len(body) - 1
                            and len(pat) == 1 and pat in "aiou"):
                        ph = {"a": ["EY"], "i": ["AY"], "o": ["OW"], "u": ["UW"]}[pat]
                    out.extend(ph)
                    i += len(pat)
                    break
            else:
                i += 1
        out.append("pau")
    return out


_DIGITS = {
    "0": ["Z", "IH", "R", "OW"], "1": ["W", "AH", "N"], "2": ["T", "UW"],
    "3": ["TH", "R", "IY"], "4": ["F", "AO", "R"], "5": ["F", "AY", "V"],
    "6": ["S", "IH", "K", "S"], "7": ["S", "EH", "V", "AH", "N"],
    "8": ["EY", "T"], "9": ["N", "AY", "N"],
}


def _resonator(signal: np.ndarray, freq: float, bw: float) -> np.ndarray:
    """2nd-order IIR formant resonator (Klatt cascade element)."""
    t = 1.0 / RATE
    c = -np.exp(-2 * np.pi * bw * t)
    b = 2 * np.exp(-np.pi * bw * t) * np.cos(2 * np.pi * freq * t)
    a = 1.0 - b - c
    out = np.empty_like(signal)
    y1 = y2 = 0.0
    for i in range(len(signal)):
        y = a * signal[i] + b * y1 + c * y2
        out[i] = y
        y2, y1 = y1, y
    return out


def _glottal(n: int, f0: np.ndarray) -> np.ndarray:
    """Impulse-ish glottal source following an f0 contour [n]."""
    phase = np.cumsum(f0) / RATE
    saw = (phase % 1.0)
    return (saw ** 2) * (1 - saw) * 8.0       # soft pulse, -12 dB/oct-ish


def _segment(ph: str, f0_base: float, rng: np.random.RandomState) -> np.ndarray:
    if ph in ("pau", "sil"):
        return np.zeros(int(RATE * (0.12 if ph == "sil" else 0.04)), np.float32)
    if ph in STOPS:
        closure, burst_f, voiced = STOPS[ph]
        n_closure = int(RATE * closure * 0.6)
        n_burst = int(RATE * 0.015)
        burst = rng.randn(n_burst) * np.exp(-np.arange(n_burst) / (RATE * 0.004))
        burst = _resonator(burst, burst_f, 1500)
        seg = np.concatenate([np.zeros(n_closure), burst * 0.5])
        if voiced:
            f0 = np.full(len(seg), f0_base)
            seg = seg + _glottal(len(seg), f0) * 0.05
        return seg.astype(np.float32)
    if ph in FRICATIVES:
        dur, center, bw, voiced = FRICATIVES[ph]
        n = int(RATE * dur)
        noise = _resonator(rng.randn(n), center, bw) * 0.15
        if voiced:
            noise = noise * 0.6 + _glottal(n, np.full(n, f0_base)) * 0.2
        return noise.astype(np.float32)
    spec = VOWELS.get(ph) or NASALS.get(ph) or LIQUIDS.get(ph)
    if spec is None:
        return np.zeros(int(RATE * 0.03), np.float32)
    dur, f1, f2, f3 = spec
    n = int(RATE * dur)
    f0 = f0_base * (1.0 + 0.06 * np.sin(np.linspace(0, np.pi, n)))
    src = _glottal(n, f0)
    out = _resonator(src, f1, 90) + 0.6 * _resonator(src, f2, 110) \
        + 0.25 * _resonator(src, f3, 160)
    if ph in NASALS:
        out *= 0.5
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.012 * RATE))
    return (out * env).astype(np.float32)


def synthesize(text: str, f0: float = 120.0, seed: int = 0) -> tuple[np.ndarray, int]:
    """``tts(text) -> (samples, rate)`` — the render pipeline's contract."""
    rng = np.random.RandomState(seed)
    phonemes = text_to_phonemes(text)
    if not phonemes:
        return np.zeros(RATE // 10, np.float32), RATE
    parts = [_segment(ph, f0, rng) for ph in phonemes]
    wav = np.concatenate(parts)
    peak = np.max(np.abs(wav))
    if peak > 0:
        wav = 0.8 * wav / peak
    return wav.astype(np.float32), RATE
