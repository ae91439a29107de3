"""``pipeline.denoise_batch``'s host loop: the output array it writes block
by block, the staged uploads and the write-back one block behind.

On the CPU: a call with no whole frame returns a copy, the tail that fills
no frame passes through for 1-D and 2-D input, read-only, reversed and
column-major inputs give the same samples, and a mesh's padded rows never
reach the output. On the card (``gpu``): the loop's output equals,
bit for bit, a hand-driven loop of the same block steps that synchronises
after each block, on both wires, with a partial block and frame, the VAD
and a mesh of one card repeated; and back-to-back calls reuse no buffer
before the card is done with it. This file imports no JAX, so the card's
machine runs it.
"""

import warnings

import numpy as np
import pytest
import torch

from crispy_tpu_torch import parallel
from crispy_tpu_torch.dsp.rnnoise import pipeline
from crispy_tpu_torch.dsp.rnnoise.weights import builtin_model
from torch_audio import speechlike

FRAME = pipeline.FRAME


def streams(S, n, seed=0):
    return np.stack([speechlike(n, seed=seed + s, f0=90.0 + 37.0 * s) for s in range(S)])


def hand_driven(x, params, block_frames, wire, devices, return_vad=False):
    """The reference loop: each shard of the zero-padded batch (one per
    entry of ``devices``) steps its own state block by block, from a plain
    contiguous upload, and the card is synchronised after each block before
    its rows are copied out."""
    step = pipeline._denoise_block_i16 if wire == "i16" else pipeline.denoise_block
    S, T = x.shape
    end = T // FRAME * FRAME
    b = -(-S // len(devices))
    padded = np.zeros((b * len(devices), T), x.dtype)
    padded[:S] = x
    out, vad = x.copy(), np.zeros((S, end // FRAME), np.float32)
    states = [pipeline.init_state(b, d) for d in devices]
    with torch.no_grad():
        for off in range(0, end, block_frames * FRAME):
            todo = min(block_frames * FRAME, end - off)
            for i, d in enumerate(devices):
                chunk = torch.from_numpy(np.ascontiguousarray(padded[i * b:(i + 1) * b, off:off + todo]))
                states[i], o, v = step({k: t.to(d) for k, t in params.items()}, states[i], chunk.to(d))
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
                n = max(min(b, S - i * b), 0)
                out[i * b:i * b + n, off:off + todo] = o.cpu().numpy()[:n]
                vad[i * b:i * b + n, off // FRAME:(off + todo) // FRAME] = v.cpu().numpy()[:n]
    return (out, vad) if return_vad else out


@pytest.fixture(scope="module")
def cpu_params():
    return pipeline.make_params(builtin_model(), "cpu")


# ---------------------------------------------------------------------------
# The output array, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_no_whole_frame_returns_a_copy(cpu_params, wire):
    x = streams(2, FRAME - 1)
    if wire == "i16":
        x = (x * 32767).astype(np.int16)
    for a in (x, x[0]):
        got = pipeline.denoise_batch(a, params=cpu_params, wire=wire, device="cpu")
        assert got.shape == a.shape and got.dtype == a.dtype
        assert got is not a and not np.shares_memory(got, a)
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("ndim", [1, 2])
def test_tail_passes_through_and_frames_are_written(cpu_params, ndim):
    """Three blocks of 2 frames over 5 frames and a tail of 123 samples: the
    frames equal the hand-driven loop's, the tail is the input's, and the
    input is left as it was."""
    x = streams(2, 5 * FRAME + 123, seed=4)
    a = x[0] if ndim == 1 else x
    keep = a.copy()
    got = pipeline.denoise_batch(a, params=cpu_params, block_frames=2, device="cpu")
    want = hand_driven(np.atleast_2d(a), cpu_params, 2, "f32", [torch.device("cpu")])
    assert got.shape == a.shape and not np.shares_memory(got, a)
    np.testing.assert_array_equal(np.atleast_2d(got), want)
    np.testing.assert_array_equal(got[..., 5 * FRAME:], a[..., 5 * FRAME:])
    np.testing.assert_array_equal(a, keep)


@pytest.mark.parametrize("layout", ["read-only", "negative stride", "column-major"])
def test_input_layouts_give_the_same_samples(cpu_params, layout):
    """The rows are read through a tensor over the input's memory; inputs
    torch cannot view as they are take a copy, the output keeps the
    input's layout, and all give the contiguous input's samples."""
    x = streams(2, 3 * FRAME + 5, seed=30)
    want = pipeline.denoise_batch(x, params=cpu_params, block_frames=2, device="cpu")
    if layout == "read-only":
        a = x.copy()
        a.flags.writeable = False
    elif layout == "negative stride":
        a = np.ascontiguousarray(x[:, ::-1])[:, ::-1]
    else:
        a = np.asfortranarray(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = pipeline.denoise_batch(a, params=cpu_params, block_frames=2, device="cpu")
    assert got.flags.writeable and not np.shares_memory(got, a)
    assert got.flags.f_contiguous == (layout == "column-major")
    np.testing.assert_array_equal(got, want)


def test_padded_mesh_rows_never_reach_the_output(cpu_params, monkeypatch):
    """S=5 over dp=4: shards of 2 rows, the third half padding, the fourth
    all padding. The step marks the padded rows' output; none of it lands
    in the output, which equals the hand-driven loop's shards bit for bit,
    VAD included."""
    real = pipeline.denoise_block

    def marking(params, state, block):
        state, o, v = real(params, state, block)
        pad = (block == 0).all(dim=1)
        return state, torch.where(pad[:, None], 9.0, o), torch.where(pad[:, None], 9.0, v)

    x = streams(5, 7 * FRAME + 50, seed=9)
    want, want_vad = hand_driven(x, cpu_params, 3, "f32", [torch.device("cpu")] * 4, return_vad=True)
    monkeypatch.setattr(pipeline, "denoise_block", marking)
    mesh = parallel.make_mesh(devices=["cpu"] * 4, model_parallel=1)
    got, vad = pipeline.denoise_batch(x, params=cpu_params, block_frames=3, mesh=mesh, return_vad=True)
    assert got.shape == x.shape and vad.shape == (5, 7)
    assert not (got == 9.0).any() and not (vad == 9.0).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vad, want_vad)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_card_matches_hand_driven_loop(cuda, wire):
    """S=3, blocks of 4 frames over 10 frames and 77 samples: two full
    blocks, a partial one and a partial frame, with the VAD."""
    x = streams(3, 10 * FRAME + 77, seed=11)
    if wire == "i16":
        x = (x * 32767).astype(np.int16)
    params = pipeline.make_params(builtin_model(), cuda)
    got, vad = pipeline.denoise_batch(x, params=params, block_frames=4, wire=wire, device=cuda,
                                      return_vad=True)
    want, want_vad = hand_driven(x, params, 4, wire, [cuda], return_vad=True)
    assert got.dtype == x.dtype and vad.shape == (3, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vad, want_vad)


@pytest.mark.gpu
def test_card_mesh_of_one_card_repeated_matches_hand_driven_loop(cuda):
    """The f32 wire over three entries of the card, S=4: shards of 2 rows,
    the last all padding, each with its own state."""
    x = streams(4, 9 * FRAME + 200, seed=21)
    params = pipeline.make_params(builtin_model(), cuda)
    mesh = parallel.make_mesh(devices=["cuda:0"] * 3, model_parallel=1)
    got, vad = pipeline.denoise_batch(x, params=params, block_frames=4, mesh=mesh, return_vad=True)
    want, want_vad = hand_driven(x, params, 4, "f32", [cuda] * 3, return_vad=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vad, want_vad)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_card_back_to_back_calls_reuse_no_buffer_early(cuda, wire):
    """Two calls of 24 blocks each on different inputs, one right after the
    other: each equals the hand-driven loop, the first is unchanged after
    the second, the inputs are unchanged, and no result shares memory with
    an input."""
    xs = [streams(64, 24 * 4 * FRAME + 31, seed=s) for s in (1, 100)]
    if wire == "i16":
        xs = [(x * 32767).astype(np.int16) for x in xs]
    keep = [x.copy() for x in xs]
    params = pipeline.make_params(builtin_model(), cuda)
    first = pipeline.denoise_batch(xs[0], params=params, block_frames=4, wire=wire, device=cuda)
    first_then = first.copy()
    second = pipeline.denoise_batch(xs[1], params=params, block_frames=4, wire=wire, device=cuda)
    np.testing.assert_array_equal(first, first_then)
    for x, k in zip(xs, keep):
        np.testing.assert_array_equal(x, k)
    for got, x in ((first, xs[0]), (second, xs[1])):
        assert not any(np.shares_memory(got, y) for y in xs)
        np.testing.assert_array_equal(got, hand_driven(x, params, 4, wire, [cuda]))
