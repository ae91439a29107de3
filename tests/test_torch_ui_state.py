"""The port's UI-side state machines (crispy_tpu_torch.api.ui_state) held
against the JAX package's: the cases of tests/test_ui_state.py on the port,
the level meter equal to JAX's with seeded random.Randoms, the progress
tracker equal to JAX's on the same event sequences, and the transcript
parser and speaker palette equal to JAX's on the same transcripts."""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from crispy_tpu.api import ui_state as jui
from crispy_tpu.api.events import EventBus as JBus
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.api.ui_state import (
    METER_EXPONENT, METER_GAIN, NOISE_FLOOR, TranscriptionProgressTracker, level_meter,
    parse_transcript_segments, speaker_color_index,
)


def test_meter_constants():
    assert (NOISE_FLOOR, METER_GAIN, METER_EXPONENT) == (0.01, 5.2, 0.3)
    assert (NOISE_FLOOR, METER_GAIN, METER_EXPONENT) == \
        (jui.NOISE_FLOOR, jui.METER_GAIN, jui.METER_EXPONENT)


class TestLevelMeter:
    def test_noise_floor_ignored(self):
        assert level_meter(0.0) == 0.0
        assert level_meter(0.009) == 0.0

    def test_curve_monotone_and_clamped(self):
        levels = [level_meter(x) for x in (0.02, 0.05, 0.1, 0.3, 0.5, 1.0)]
        assert levels == sorted(levels)
        assert levels[-1] == 1.0
        want = min((0.09 / 0.99) * 5.2, 1.0) ** 0.3
        assert level_meter(0.1) == pytest.approx(want)

    def test_noisy_model_adds_jitter(self):
        v = level_meter(0.0, model_name="noisy", rng=random.Random(0))
        assert 0.05 <= v <= 0.11  # 0.08 base ± 0.03

    @pytest.mark.parametrize("model", [None, "rnnoise", "dummy", "noisy"])
    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_equals_jax_with_seeded_rngs(self, model, seed):
        raws = np.random.default_rng(seed).uniform(-0.1, 1.5, 200).tolist()
        raws += [0.0, 0.01, 0.009, 1.0, 0.2023, float(np.float32(0.5))]
        r_port, r_jax = random.Random(seed), random.Random(seed)
        got = [level_meter(x, model_name=model, rng=r_port) for x in raws]
        want = [jui.level_meter(x, model_name=model, rng=r_jax) for x in raws]
        assert got == want
        assert all(0.0 <= v <= 1.0 for v in got)


def status(path, s, error=None):
    return ("transcription-status", {"recording_path": path, "status": s, "error": error})


class TestProgressTracker:
    def test_full_lifecycle(self):
        bus = EventBus()
        tr = TranscriptionProgressTracker(bus=bus)
        bus.emit(*status("/r/a.wav", "started"))
        assert tr.get("/r/a.wav")["phase"] == "preparing-audio"
        bus.emit("transcription-phase", {"recording_path": "/r/a.wav", "phase": "transcribing"})
        bus.emit("transcription-progress",
                 {"recording_path": "/r/a.wav", "progress": 0.5, "eta_seconds": 12})
        st_ = tr.get("/r/a.wav")
        assert st_["progress"] == 0.5 and st_["eta_seconds"] == 12
        assert st_["phase"] == "transcribing"
        bus.emit(*status("/r/a.wav", "completed"))
        st_ = tr.get("/r/a.wav")
        assert st_["status"] == "completed" and st_["progress"] == 1.0
        assert st_["has_result"] is True

    def test_restore_only_inflight(self):
        tr = TranscriptionProgressTracker(bus=EventBus())
        tr.restore({
            "/r/live.wav": {"status": "transcribing", "progress": 0.3,
                            "eta_seconds": 5, "phase": "transcribing"},
            "/r/done.wav": {"status": "completed", "progress": 1.0},
        })
        assert tr.get("/r/live.wav")["progress"] == 0.3
        assert tr.get("/r/done.wav") is None

    def test_error_and_cancel(self):
        bus = EventBus()
        tr = TranscriptionProgressTracker(bus=bus)
        bus.emit(*status("/r/x.wav", "error", "boom"))
        assert tr.get("/r/x.wav")["error"] == "boom"
        bus.emit(*status("/r/x.wav", "cancelled"))
        st_ = tr.get("/r/x.wav")
        assert st_["status"] == "cancelled" and st_["error"] is None

    def test_close_stops_listening(self):
        bus = EventBus()
        tr = TranscriptionProgressTracker(bus=bus)
        tr.close()
        bus.emit(*status("/r/a.wav", "started"))
        assert tr.snapshot() == {}

    def test_end_to_end_with_real_pipeline(self, data_root, tmp_path):
        from crispy_tpu_torch.api.commands import CrispyApp
        from crispy_tpu_torch.engine import transcription as trm
        from crispy_tpu_torch.io import wav as wavio

        app = CrispyApp(bus=EventBus(), device="cpu")
        tracker = TranscriptionProgressTracker(bus=app.bus, app=app)
        app.set_active_model("small")
        eng = type("E", (trm.EngineProtocol,), {
            "transcribe_batch": lambda self, c, language="en": ["ok"] * len(c)})()
        app.transcription_manager._loader = lambda mid, mm: eng
        wav = wavio.write_wav(tmp_path / "r.wav", 0.2 * np.ones((32000, 1), np.float32), 16000)
        th = app.start_transcription(str(wav))
        th.join(timeout=60)
        st_ = tracker.get(str(wav))
        assert st_["status"] == "completed" and st_["progress"] == 1.0


PATHS = ["/r/a.wav", "/r/b.wav"]
_event = st.one_of(
    st.tuples(st.just("transcription-status"), st.fixed_dictionaries({
        "recording_path": st.sampled_from(PATHS),
        "status": st.sampled_from(["started", "completed", "error", "cancelled", "queued"]),
        "error": st.sampled_from([None, "", "boom"])})),
    st.tuples(st.just("transcription-progress"), st.fixed_dictionaries(
        {"recording_path": st.sampled_from(PATHS)},
        optional={"progress": st.floats(0, 1), "eta_seconds": st.sampled_from([None, 0, 7])})),
    st.tuples(st.just("transcription-phase"), st.fixed_dictionaries({
        "recording_path": st.sampled_from(PATHS),
        "phase": st.sampled_from(["preparing-audio", "loading-model", "transcribing",
                                  "diarizing", None])})),
)
_backend = st.dictionaries(st.sampled_from(PATHS + ["/r/c.wav"]), st.fixed_dictionaries(
    {"status": st.sampled_from(["started", "transcribing", "completed", "error"])},
    optional={"progress": st.floats(0, 1), "eta_seconds": st.sampled_from([None, 3]),
              "phase": st.sampled_from([None, "transcribing"])}), max_size=3)


@settings(max_examples=200, deadline=None)
@given(backend=_backend, events=st.lists(_event, max_size=30))
def test_tracker_equals_jax(backend, events):
    bus, jbus = EventBus(), JBus()
    tr, jtr = TranscriptionProgressTracker(bus=bus), jui.TranscriptionProgressTracker(bus=jbus)
    tr.restore(backend)
    jtr.restore(backend)
    assert tr.snapshot() == jtr.snapshot()
    for name, payload in events:
        bus.emit(name, dict(payload))
        jbus.emit(name, dict(payload))
        assert tr.snapshot() == jtr.snapshot()
    for p in PATHS:
        assert tr.get(p) == jtr.get(p)


class TestTranscriptParser:
    def test_diarized_blocks(self):
        content = ("[Speaker 1|0.0]\nhello there\n[Speaker 2|4.5]\nhi\nagain\n"
                   "[Speaker 1|9.2]\nback")
        assert parse_transcript_segments(content) == [
            {"speaker": "Speaker 1", "timestamp": 0.0, "text": "hello there"},
            {"speaker": "Speaker 2", "timestamp": 4.5, "text": "hi again"},
            {"speaker": "Speaker 1", "timestamp": 9.2, "text": "back"},
        ]

    def test_header_without_timestamp_and_plain_text(self):
        segs = parse_transcript_segments("intro text\n[Speaker 3]\nwords")
        assert segs[0] == {"speaker": "", "timestamp": None, "text": "intro text"}
        assert segs[1]["speaker"] == "Speaker 3" and segs[1]["timestamp"] is None

    def test_plain_transcript_has_no_speakers(self):
        assert parse_transcript_segments("just a plain transcript line") == [
            {"speaker": "", "timestamp": None, "text": "just a plain transcript line"}]

    def test_round_trip_with_formatter(self):
        from crispy_tpu_torch.engine.diarization import SpeakerSegment, format_diarized_text

        text = format_diarized_text(
            [(0.0, 2.0, "one"), (2.0, 4.0, "two"), (5.0, 7.0, "three")],
            [SpeakerSegment(0.0, 4.0, "Speaker 1"), SpeakerSegment(4.0, 8.0, "Speaker 2")],
        )
        segs = parse_transcript_segments(text)
        assert [s["speaker"] for s in segs] == ["Speaker 1", "Speaker 2"]
        assert segs[0]["text"] == "one two" and segs[1]["text"] == "three"

    @pytest.mark.parametrize("speaker,slot", [
        ("Speaker 1", 0), ("Speaker 9", 0), ("Speaker 2", 1), ("Speaker 16", 7), ("Alice", None)])
    def test_speaker_colors_stable(self, speaker, slot):
        got = speaker_color_index(speaker)
        assert got == jui.speaker_color_index(speaker)
        assert 0 <= got < 8 and (slot is None or got == slot)


_line = st.one_of(
    st.builds(lambda n, t: f"[Speaker {n}{'' if t is None else '|' + t}]",
              st.integers(0, 12), st.one_of(st.none(), st.sampled_from(["0", "4.5", "12.25",
                                                                         "x", "1."]))),
    st.sampled_from(["[Alice|3]", "[]", "[Speaker 1|2.0] trailing", "  [Speaker 2|1.0]  ",
                     "", " ", "hello there", "  spaced words  ", "ünïcode text"]),
    st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=20))


@settings(max_examples=300, deadline=None)
@given(lines=st.lists(_line, max_size=12))
def test_parser_equals_jax(lines):
    content = "\n".join(lines)
    assert parse_transcript_segments(content) == jui.parse_transcript_segments(content)
    for seg in parse_transcript_segments(content):
        if seg["speaker"]:
            assert speaker_color_index(seg["speaker"]) == \
                jui.speaker_color_index(seg["speaker"])
