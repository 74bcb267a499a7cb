"""Audio subsystem (headless): music playlists, effect channels,
positional 3D effects tied to entities.

The port's own copy of ``permafrost_engine_tpu/core/audio.py``, unchanged.

Mirrors the reference's OpenAL layer state machine (ref: src/audio/
al_audio.c, al_effect.c; API audio.h:45-68): playlist modes, 4 foreground
effect channels, per-entity positional effects, pause/resume with time
delta, and save/load. There is no audio device in this environment, so
playback is modelled (track positions advance with the tick clock) — the
full state surface exists for scripts and session save.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum


class PlaybackMode(IntEnum):
    MUSIC_MODE_LOOP = 0
    MUSIC_MODE_PLAYLIST = 1
    MUSIC_MODE_SHUFFLE = 2


NUM_FG_CHANNELS = 4  # ref: audio.h foreground effect channels


@dataclasses.dataclass
class EffectChannel:
    name: str | None = None
    started_tick: int = 0


@dataclasses.dataclass
class PositionalEffect:
    name: str
    pos: tuple
    uid: int | None = None
    started_tick: int = 0


class AudioSystem:
    def __init__(self):
        self.tracks: list[str] = []     # "loaded" music library
        self.effects: set[str] = set()  # known effect names
        self.mode = PlaybackMode.MUSIC_MODE_LOOP
        self.current: str | None = None
        self.playing = False
        self.master_volume = 1.0
        self.music_volume = 1.0
        self.effect_volume = 1.0
        self.mute_on_focus_loss = False
        self.channels = [EffectChannel() for _ in range(NUM_FG_CHANNELS)]
        self.positional: list[PositionalEffect] = []
        self._tick = 0
        self._paused_at: int | None = None

    # -- music ----------------------------------------------------------------

    def add_tracks(self, names: list[str]) -> None:
        self.tracks.extend(n for n in names if n not in self.tracks)

    def play_music(self, name: str) -> bool:
        if self.tracks and name not in self.tracks:
            self.tracks.append(name)
        self.current = name
        self.playing = True
        return True

    def curr_music(self) -> str | None:
        return self.current

    def all_music(self) -> list[str]:
        return list(self.tracks)

    # -- effects ---------------------------------------------------------------

    def play_global_effect(self, name: str, interrupt: bool = False,
                           channel: int = 0) -> bool:
        ch = self.channels[channel % NUM_FG_CHANNELS]
        if ch.name is not None and not interrupt:
            return False
        ch.name = name
        ch.started_tick = self._tick
        return True

    def play_effect(self, name: str, pos, uid: int | None = None) -> bool:
        self.positional.append(
            PositionalEffect(name, tuple(pos), uid, self._tick))
        return True

    # -- clock / pause (ref: pause/resume with time delta) ----------------------

    def tick(self, n: int = 1) -> None:
        if self._paused_at is None:
            self._tick += n
            # expire foreground/positional effects after ~2s
            for ch in self.channels:
                if ch.name and self._tick - ch.started_tick > 120:
                    ch.name = None
            self.positional = [
                p for p in self.positional if self._tick - p.started_tick <= 120]

    def pause(self) -> None:
        if self._paused_at is None:
            self._paused_at = self._tick

    def resume(self) -> None:
        self._paused_at = None

    # -- offline mixdown (the OpenAL output path, rendered headless) -------------
    #
    # There is no audio device here, so the device half of al_audio.c is an
    # offline mix: sources scheduled on the engine's 60 Hz clock, positional
    # attenuation + stereo panning relative to a listener, per-bus volumes,
    # 16-bit stereo WAV out. Real .wav assets are used when found in
    # `search_dirs`; unknown names get a deterministic synthesized tone so
    # the pipeline is exercisable without assets.

    SAMPLE_RATE = 22050
    EFFECT_TICKS = 120                 # effect lifetime (~2 s; see tick())

    def _source_pcm(self, name: str, seconds: float,
                    search_dirs=()) -> "np.ndarray":
        import os
        import numpy as np
        n = int(seconds * self.SAMPLE_RATE)
        for d in search_dirs:
            p = os.path.join(d, name if name.endswith(".wav")
                             else name + ".wav")
            if os.path.exists(p):
                import wave
                with wave.open(p, "rb") as w:
                    raw = np.frombuffer(w.readframes(w.getnframes()),
                                        np.int16).astype(np.float32) / 32768
                    if w.getnchannels() > 1:
                        raw = raw.reshape(-1, w.getnchannels()).mean(1)
                reps = max(1, -(-n // max(len(raw), 1)))
                return np.tile(raw, reps)[:n]
        # deterministic placeholder: enveloped two-partial tone per name.
        # crc32, not hash(): str hash is randomized per process and would
        # break cross-run mixdown determinism / golden-file comparisons.
        import zlib
        rng = np.random.default_rng(zlib.crc32(name.encode("utf-8")))
        f0 = 160.0 + rng.random() * 500.0
        t = np.arange(n) / self.SAMPLE_RATE
        env = np.exp(-t * (1.5 + rng.random() * 3))
        sig = env * (np.sin(2 * np.pi * f0 * t)
                     + 0.4 * np.sin(2 * np.pi * f0 * 2.01 * t))
        return sig.astype(np.float32) * 0.6

    def render_wav(self, path: str, seconds: float = 2.0,
                   listener_pos=(0.0, 0.0, 0.0), search_dirs=()) -> int:
        """Mix the currently-audible sources into a stereo WAV.

        Returns the number of sources mixed. Positional effects attenuate
        with distance and pan by x-offset from the listener (ref:
        al_effect.c positional sources; AL_POSITION + listener)."""
        import wave
        import numpy as np
        n = int(seconds * self.SAMPLE_RATE)
        mix = np.zeros((n, 2), np.float32)

        def add(name, gain_l, gain_r, elapsed_ticks=0):
            """Mix a source that started `elapsed_ticks` ago: its remainder
            plays from the window start (pause/resume keeps the delta)."""
            src_off = int(elapsed_ticks / 60.0 * self.SAMPLE_RATE)
            pcm = self._source_pcm(name, seconds + src_off / self.SAMPLE_RATE,
                                   search_dirs)
            seg = pcm[src_off:src_off + n]
            mix[:len(seg), 0] += seg * gain_l
            mix[:len(seg), 1] += seg * gain_r

        count = 0
        if self.playing and self.current:
            g = self.master_volume * self.music_volume * 0.5
            add(self.current, g, g)
            count += 1
        for ch in self.channels:
            if ch.name:
                g = self.master_volume * self.effect_volume
                add(ch.name, g, g, max(0, self._tick - ch.started_tick))
                count += 1
        lx, _, lz = listener_pos
        for p in self.positional:
            dx = p.pos[0] - lx
            dz = (p.pos[1] if len(p.pos) == 2 else p.pos[2]) - lz
            dist = (dx * dx + dz * dz) ** 0.5
            att = 1.0 / (1.0 + dist / 24.0)
            pan = max(-1.0, min(1.0, dx / 60.0))
            g = self.master_volume * self.effect_volume * att
            gl = g * (0.5 * (1 - pan) + 0.5 * (1 - abs(pan)))
            gr = g * (0.5 * (1 + pan) + 0.5 * (1 - abs(pan)))
            add(p.name, gl, gr, max(0, self._tick - p.started_tick))
            count += 1

        peak = float(np.abs(mix).max())
        if peak > 1.0:
            mix /= peak
        pcm16 = (mix * 32767).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(self.SAMPLE_RATE)
            w.writeframes(pcm16.tobytes())
        return count

    # -- save/load ----------------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "tracks": list(self.tracks), "mode": int(self.mode),
            "current": self.current, "playing": self.playing,
            "volumes": (self.master_volume, self.music_volume,
                        self.effect_volume),
            "tick": self._tick,
        }

    def restore(self, snap: dict) -> None:
        self.tracks = list(snap["tracks"])
        self.mode = PlaybackMode(snap["mode"])
        self.current = snap["current"]
        self.playing = snap["playing"]
        (self.master_volume, self.music_volume,
         self.effect_volume) = snap["volumes"]
        self._tick = snap["tick"]
