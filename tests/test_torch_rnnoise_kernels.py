"""The port's kernel modules (crispy_tpu_torch rnn_kernels / ops_kernels)
held against the JAX package on the CPU, and their CUDA kernels held against
their plain versions on the card.

On the CPU the wrappers take their plain PyTorch versions; those are compared
with the JAX functions on the same numpy inputs (the Pallas kernels in
interpret mode, as the JAX package's own tests run them). The tests marked
``gpu`` build the CUDA kernels and compare them with the plain versions on
the card; here, without a card, they skip.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp.rnnoise import constants as TC
from crispy_tpu_torch.dsp.rnnoise import ops_kernels as ok
from crispy_tpu_torch.dsp.rnnoise import pipeline as tp
from crispy_tpu_torch.dsp.rnnoise import rd_rows
from crispy_tpu_torch.dsp.rnnoise import rnn_kernels as rk
from crispy_tpu_torch.dsp.rnnoise import weights as tw

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.dsp.rnnoise import constants as JC
    from crispy_tpu.dsp.rnnoise import jax_pipeline as jp
    from crispy_tpu.dsp.rnnoise import pallas_ops as jops
    from crispy_tpu.dsp.rnnoise import pallas_rnn as jrnn
    from crispy_tpu.dsp.rnnoise.weights import deterministic_test_model
except ImportError:
    jp = None
needs_jax = pytest.mark.skipif(jp is None, reason="the JAX reference is not installed")

WIN = TC.WINDOW_SIZE


@pytest.fixture(scope="module")
def jparams():
    return jp.make_params(deterministic_test_model())


@pytest.fixture(scope="module")
def tparams():
    return tp.make_params(tw.deterministic_test_model(), "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def t(x):
    return torch.from_numpy(np.array(x))


def nn_inputs(seed=11, S=3, F=9):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((S, F, 42)).astype(np.float32)
    sil = rng.random((S, F)) < 0.3
    state = {
        "gru_vad": rng.random((S, 24)).astype(np.float32) * 0.5,
        "gru_noise": rng.random((S, 48)).astype(np.float32) * 0.5,
        "gru_denoise": rng.random((S, 96)).astype(np.float32) * 0.5,
        "lastg": rng.random((S, 22)).astype(np.float32),
    }
    return feats, sil, state


def off_grid(params, seed=19):
    """The same parameters with every weight matrix moved off the fp16 grid
    by up to 1e-3 (as an npz of arbitrary f32 weights may be)."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for k in rk._MATRICES:
        w = params[k]
        d = torch.from_numpy(rng.uniform(-1e-3, 1e-3, tuple(w.shape)).astype(np.float32))
        out[k] = (w + d.to(w.device)).contiguous()
    return out


def max_diff(xs, ys):
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))


def float64_reference(params, state, feats, silence, monkeypatch):
    """nn_scan_reference run in float64 (tansig without its f32 cast), as
    the list of outputs then states."""
    def tansig64(table, x):
        ax = torch.abs(x)
        fi = torch.clamp(torch.floor(0.5 + 25.0 * torch.nan_to_num(ax)), 0.0, 200.0)
        dx = ax - 0.04 * fi
        y = table[fi.to(torch.int64)]
        y = y + dx * (1.0 - y * y) * (1.0 - y * dx)
        out = torch.where(x < 0, -y, y)
        out = torch.where(x >= 8.0, 1.0, torch.where(x <= -8.0, -1.0, out))
        return torch.where(torch.isnan(x), 0.0, out)

    monkeypatch.setattr(rk, "_tansig", tansig64)
    p64 = {k: v.double() if v.dtype == torch.float32 else v for k, v in params.items()}
    outs, st = rk.nn_scan_reference(p64, {k: v.double() for k, v in state.items()},
                                    feats.double(), silence)
    monkeypatch.undo()
    return list(outs) + list(st.values())


def rd_inputs(seed=3, S=3, F=11):
    return rd_rows.random_rows(np.random.default_rng(seed), S, F)


def continuation_rows(seed=10, S=3, F=40):
    """K2 rows heavy in continuations and exact ties (rd_rows.continuation_rows)."""
    return rd_rows.continuation_rows(np.random.default_rng(seed), S, F)


def with_nans(packed, lp0, lg0):
    """Copies with NaN in some g0, g1, output periods and pitch gains (so
    NaN carries also arise inside the scan) and in both carries (S >= 4)."""
    packed, lp0, lg0 = packed.copy(), lp0.copy(), lg0.copy()
    packed[0, 2, 42] = np.nan  # g0
    packed[1, 1, 14:20] = np.nan  # g1
    packed[-1, -1, 20] = np.nan
    packed[2, 3, 44:59] = np.nan  # Tout: a NaN pitch and period carry
    packed[3, 5, 59:74] = np.nan  # pg: a NaN gain carry
    lp0[1] = np.nan
    lg0[2] = np.nan
    return packed, lp0, lg0


def lane_form_scan(packed, lp0, lg0):
    """The algebraic rewrite csrc/rd_scan.cu is built on, in float32 numpy,
    all lanes at once: the carry-free parts (a, lo, gl, c0, the
    5 (k+2)^2 < T0 flag) formed apart, g1 > max(lo, a - cont) taken as
    (g1 > lo) and (g1 > a - cont), the winner's slot from the ballot mask as
    its bit length (32 - clz). A model of the rewrite, not of the kernel:
    it shows on the CPU that the rewrite keeps the plain version's bits;
    the card tests below hold the kernel itself to the plain version."""
    f32 = np.float32
    S, F, _ = packed.shape
    c5 = (5 * (np.arange(14) + 2) ** 2).astype(f32)
    prev_T, prev_g = lp0.astype(f32), lg0.astype(f32)
    pitch = np.empty((S, F), f32)
    rows = np.arange(S)
    with np.errstate(invalid="ignore"):
        for f in range(F):
            r = packed[:, f]
            T1, g1, valid, g0 = r[:, 0:14], r[:, 14:28], r[:, 28:42], r[:, 42:43]
            lt90 = T1 < 90
            a = np.where(lt90, f32(0.85) * g0, f32(0.7) * g0)
            gl = (valid > 0.5) & (g1 > np.where(lt90, f32(0.4), f32(0.3)))
            c0 = gl & (g1 > a)
            flag = c5 < r[:, 43:44]
            d = np.abs(T1 - np.floor(prev_T * f32(0.5))[:, None])
            c1 = gl & (g1 > a - prev_g[:, None])
            c2 = gl & (g1 > a - f32(0.5) * prev_g[:, None])
            win = np.where(d <= 1, c1, np.where((d <= 2) & flag, c2, c0))
            src = np.frexp((win * (1 << np.arange(14))).sum(-1))[1]  # bit length
            prev_T, prev_g = r[rows, 44 + src], r[rows, 59 + src]
            pitch[:, f] = prev_T
    return pitch, prev_T, prev_g


def gather_inputs(seed=5, S=3, F=6):
    rng = np.random.default_rng(seed)
    L = tp.HIST + 1 + F * 480
    ext = rng.standard_normal((S, L)).astype(np.float32)
    starts = (1 + np.arange(F)[None, :] * 480 + (tp.PBUF - WIN)
              - rng.integers(60, 768, (S, F))).astype(np.int32)
    starts[0, 0] = -7  # counts from the end, then clamped to L - 960
    starts[0, 1] = -L - 30  # before the start even from the end: clamped to 0
    starts[1, -1] = L - 100  # clamped to L - 960
    starts[2, 2] = L + 5000  # far past the end
    return ext, starts


# ---------------------------------------------------------------------------
# K1: the GRU network scan
# ---------------------------------------------------------------------------

class TestNnScan:
    @needs_jax
    @pytest.mark.parametrize("against", ["xla_scan", "pallas_interpret"])
    def test_plain_matches_jax(self, jparams, tparams, against):
        """nn_scan on CPU tensors (its plain version) == jax_pipeline._nn_scan
        and nn_scan_pallas in interpret mode, with silence gating, lastg
        smoothing and the state carry."""
        feats, sil, state = nn_inputs()
        jstate = {k: jnp.asarray(v) for k, v in state.items()}
        if against == "xla_scan":
            (a1, a2, a3), st_a = jp._nn_scan(jparams, jstate, jnp.asarray(feats),
                                             jnp.asarray(sil))
        else:
            (a1, a2, a3), st_a = jrnn.nn_scan_pallas(jparams, jstate, jnp.asarray(feats),
                                                     jnp.asarray(sil), interpret=True)
        tstate = {k: t(v) for k, v in state.items()}
        before = rk.nn_scan.launches
        (b1, b2, b3), st_b = rk.nn_scan(tparams, tstate, t(feats), t(sil))
        assert rk.nn_scan.launches == before  # CPU tensors never launch the kernel
        for x, y in ((a1, b1), (a2, b2), (a3, b3)):
            np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=1e-6)
        for k in st_a:
            np.testing.assert_allclose(np.asarray(st_a[k]), st_b[k].numpy(), atol=1e-6)

    @needs_jax
    def test_tansig_matches_oracle_table(self, tparams):
        """The table tansig is the oracle's tansig_approx, bit for bit,
        including saturation and NaN."""
        x = np.concatenate([np.linspace(-9, 9, 4001, dtype=np.float32),
                            np.array([np.nan, np.inf, -np.inf], np.float32)])
        got = rk._tansig(tparams["tansig_table"], t(x)).numpy()
        np.testing.assert_array_equal(got, JC.tansig_approx(x))

    @pytest.mark.gpu
    def test_kernel_matches_plain_on_card(self, cuda, tparams):
        feats, sil, state = nn_inputs(seed=12, S=5, F=40)
        params = {k: v.to(cuda) for k, v in tparams.items()}
        tstate = {k: t(v).to(cuda) for k, v in state.items()}
        f, s = t(feats).to(cuda), t(sil).to(cuda)
        before = rk.nn_scan.launches
        a, st_a = rk.nn_scan(params, tstate, f, s)
        assert rk.nn_scan.launches == before + 1
        b, st_b = rk.nn_scan_reference(params, tstate, f, s)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        for k in st_a:
            torch.testing.assert_close(st_a[k], st_b[k], atol=1e-5, rtol=0)

    @pytest.mark.gpu
    @pytest.mark.parametrize("S", [1, 8, 128, 256])
    @pytest.mark.parametrize("F", [1, 7, 500])
    def test_both_variants_match_plain_on_card(self, cuda, S, F, monkeypatch):
        """The resident variant on the builtin weights and the f32 variant on
        off-grid weights, against the plain version at 1e-5, with silence
        all on, all off and random; each launch counts in its own counter.

        Over 500 frames of N(0, 1) features the GRU states grow large, and
        the f32 plain version itself can then lie farther than 1e-5 from the
        same recurrence run in float64. Where a kernel is more than 1e-5
        from the plain version, it must be no farther from the float64 run
        than the plain version is."""
        feats, _, state = nn_inputs(seed=S + F, S=S, F=F)
        rng = np.random.default_rng(S * F)
        grid = tp.make_params(tw.builtin_model(), cuda)
        cases = (("resident", grid), ("f32", off_grid(grid)))
        f = t(feats).to(cuda)
        tstate = {k: t(v).to(cuda) for k, v in state.items()}
        for sil in (np.ones((S, F), bool), np.zeros((S, F), bool), rng.random((S, F)) < 0.3):
            s = t(sil).to(cuda)
            for variant, params in cases:
                counts = (rk.nn_scan.launches, rk.nn_scan.launches_f32)
                a, st_a = rk.nn_scan(params, tstate, f, s)
                want = (counts[0] + 1, counts[1]) if variant == "resident" else \
                    (counts[0], counts[1] + 1)
                assert (rk.nn_scan.launches, rk.nn_scan.launches_f32) == want
                b, st_b = rk.nn_scan_reference(params, tstate, f, s)
                got, plain = list(a) + list(st_a.values()), list(b) + list(st_b.values())
                if max_diff(got, plain) > 1e-5:
                    exact = float64_reference(params, tstate, f, s, monkeypatch)
                    assert max_diff(got, exact) <= max_diff(plain, exact), variant
                if sil.all():
                    assert not a[2].any()
                    for k in st_a:
                        assert torch.equal(st_a[k], tstate[k])

    @pytest.mark.gpu
    @pytest.mark.parametrize("variant", ["resident", "f32"])
    def test_nan_row_and_repeat_launch_on_card(self, cuda, variant):
        """A NaN feature row gives the plain version's NaNs and numbers, and
        a second launch on the same inputs gives the same bits."""
        feats, sil, state = nn_inputs(seed=13, S=9, F=30)
        feats[2, 11] = np.nan
        feats[5, 0, 7] = np.nan
        params = tp.make_params(tw.builtin_model(), cuda)
        if variant == "f32":
            params = off_grid(params)
        f, s = t(feats).to(cuda), t(sil).to(cuda)
        tstate = {k: t(v).to(cuda) for k, v in state.items()}
        a, st_a = rk.nn_scan(params, tstate, f, s)
        a2, st_a2 = rk.nn_scan(params, tstate, f, s)
        b, st_b = rk.nn_scan_reference(params, tstate, f, s)
        for x, y in list(zip(a, b)) + [(st_a[k], st_b[k]) for k in st_a]:
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0, equal_nan=True)
        for x, y in list(zip(a, a2)) + [(st_a[k], st_a2[k]) for k in st_a]:
            assert torch.equal(torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))
        assert torch.isnan(st_a["gru_noise"][2]).all() or bool(sil[2, 11])

    # -- the resident variant's fp16 weights (plain functions, on the CPU) --

    @pytest.mark.parametrize("which", ["builtin", "deterministic"])
    def test_grid_weights_exact_in_half(self, which):
        model = tw.builtin_model() if which == "builtin" else tw.deterministic_test_model()
        params = tp.make_params(model, "cpu")
        assert rk.exact_in_half(params)
        packed = rk.pack_half_weights(params)
        assert packed.dtype == torch.float16 and packed.numel() == 2 * 46464
        n_weights = sum(params[k].numel() for k in rk._MATRICES)
        assert int((packed != 0).sum()) == int(sum((params[k] != 0).sum() for k in rk._MATRICES))
        assert n_weights == 86952

    @pytest.mark.parametrize("key", ["input_dense.w", "vad_gru.u", "noise_gru.w",
                                     "denoise_gru.u", "denoise_output.w", "vad_output.w"])
    def test_one_moved_weight_is_rejected(self, tparams, key):
        params = dict(tparams)
        w = params[key].clone()
        w.view(-1)[w.numel() // 2] += 1e-3
        params[key] = w
        assert rk.exact_in_half(tparams) and not rk.exact_in_half(params)

    def test_segments_cover_each_weight_once(self, tparams):
        for key in rk._MATRICES:
            hit = np.zeros(tuple(tparams[key].shape), int)
            for k, (r0, r1), (c0, c1), _ in rk._SEGMENTS:
                if k == key:
                    hit[r0:r1, c0:c1] += 1
            assert (hit == 1).all(), key

    def test_packed_layout_is_what_the_lanes_read(self, tparams):
        """Read the packed vector as the kernel's lanes do (16-byte word
        (tile * 3 + run) * 32 + lane holds, for column tile * 32/G + lane // G,
        the pairs p = (run * G + lane % G) * 4 + i, i < 4, of rows 2p and
        2p + 1) and sum: each segment's product equals act @ M on its slice."""
        rng = np.random.default_rng(17)
        words = rk.pack_half_weights(tparams).float().numpy().reshape(-1, 2)
        off = 0
        for key, (r0, r1), (c0, c1), G in rk._SEGMENTS:
            m = tparams[key][r0:r1, c0:c1].numpy()
            act = np.zeros(2 * rk._STEPS * G)
            act[: r1 - r0] = rng.standard_normal(r1 - r0)
            cpt = 32 // G
            ntiles = -(-(c1 - c0) // cpt)
            idx = np.arange(ntiles * rk._STEPS * 32)  # one (fp16, fp16) pair each
            word, i = idx // 4, idx % 4
            tile, run, lane = word // (3 * 32), (word // 32) % 3, word % 32
            col, pair = tile * cpt + lane // G, (run * G + lane % G) * 4 + i
            w = words[off: off + idx.size]
            got = np.zeros(ntiles * cpt)
            np.add.at(got, col, act[2 * pair] * w[:, 0] + act[2 * pair + 1] * w[:, 1])
            np.testing.assert_allclose(got[: c1 - c0], act[: r1 - r0] @ m, atol=1e-12)
            assert not got[c1 - c0:].any()
            off += idx.size
        assert off == words.shape[0]

    def test_half_weights_cached_per_parameter_set(self, tparams):
        params = dict(tparams)
        a = rk._half_weights(params)
        assert a is not None and rk._half_weights(params) is a
        params["vad_gru.w"] = params["vad_gru.w"] + 1e-3  # another parameter set
        assert rk._half_weights(params) is None
        params["vad_gru.w"].copy_(tparams["vad_gru.w"])  # changed in place
        assert torch.equal(rk._half_weights(params), a)


# ---------------------------------------------------------------------------
# K2: the remove_doubling continuation scan
# ---------------------------------------------------------------------------

class TestRdScan:
    @needs_jax
    def test_plain_matches_pallas_bit_exact(self):
        """rd_scan on CPU tensors == rd_scan_pallas (interpret mode) bit for
        bit: thresholds, candidate selection and the (period, gain) carry."""
        packed, lp0, lg0 = rd_inputs()
        want = jrnn.rd_scan_pallas(jnp.asarray(packed), jnp.asarray(lp0), jnp.asarray(lg0),
                                   interpret=True)
        got = rk.rd_scan(t(packed), t(lp0), t(lg0))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())

    @needs_jax
    def test_continuation_thresholds_bit_exact(self):
        """Inputs built to sit on the continuation branches (candidates one
        and two half-periods from the previous period, gains at the
        threshold boundaries) stay bit-exact too."""
        rng = np.random.default_rng(7)
        packed, lp0, lg0 = rd_inputs(seed=8, S=3, F=12)
        pph = np.floor(lp0 * 0.5)
        packed[:, 0, 0:14] = pph[:, None] + rng.integers(-2, 3, (3, 14))
        packed[:, :, 14:28] = np.round(packed[:, :, 14:28] * 8) / 8  # many exact ties
        packed[:, :, 42] = np.round(packed[:, :, 42] * 8) / 8
        want = jrnn.rd_scan_pallas(jnp.asarray(packed), jnp.asarray(lp0), jnp.asarray(lg0),
                                   interpret=True)
        got = rk.rd_scan(t(packed), t(lp0), t(lg0))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())

    @needs_jax
    @pytest.mark.parametrize("rows", ["random", "continuation"])
    def test_carry_hand_over_bit_exact(self, rows):
        """rd_scan over F frames == two calls over F // 2 and F - F // 2 with
        the carries passed on == rd_scan_pallas (interpret mode) over the
        whole block, bit for bit."""
        make = rd_inputs if rows == "random" else continuation_rows
        packed, lp0, lg0 = make(seed=21, S=3, F=23)
        want = jrnn.rd_scan_pallas(jnp.asarray(packed), jnp.asarray(lp0), jnp.asarray(lg0),
                                   interpret=True)
        whole = rk.rd_scan(t(packed), t(lp0), t(lg0))
        h = packed.shape[1] // 2
        p1, lp1, lg1 = rk.rd_scan(t(packed[:, :h]), t(lp0), t(lg0))
        p2, lp2, lg2 = rk.rd_scan(t(packed[:, h:]), lp1, lg1)
        for w, g, s in zip(want, whole, (torch.cat([p1, p2], dim=1), lp2, lg2)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            assert torch.equal(g, s)

    @pytest.mark.parametrize("why", ["none valid", "gains too low"])
    def test_no_winner_takes_slot_0(self, why):
        packed, lp0, lg0 = rd_inputs(seed=22, S=4, F=9)
        if why == "none valid":
            packed[..., 28:42] = 0.0
        else:
            packed[..., 14:28] = 0.25  # under every threshold's floor, 0.3
        pitch, lp, lg = rk.rd_scan(t(packed), t(lp0), t(lg0))
        assert torch.equal(pitch, t(packed[..., 44]))
        assert torch.equal(lp, t(packed[:, -1, 44])) and torch.equal(lg, t(packed[:, -1, 59]))

    @pytest.mark.parametrize("carry", ["finite", "nan"])
    def test_every_winner_takes_slot_14(self, carry):
        packed, lp0, lg0 = rd_inputs(seed=23, S=4, F=9)
        packed[..., 14:28] = 2.0  # over every threshold: g0 < 1, cont >= 0
        packed[..., 28:42] = 1.0
        if carry == "nan":
            lp0[:], lg0[:] = np.nan, np.nan
        pitch, lp, lg = rk.rd_scan(t(packed), t(lp0), t(lg0))
        assert torch.equal(pitch, t(packed[..., 58]))
        assert torch.equal(lp, t(packed[:, -1, 58])) and torch.equal(lg, t(packed[:, -1, 73]))

    @pytest.mark.parametrize("rows", ["random", "continuation", "nan"])
    def test_lane_form_matches_plain(self, rows):
        """The rewrite of the threshold test and of the last winner that the
        kernel is built on (lane_form_scan) equals the plain version bit for
        bit, NaNs included."""
        args = continuation_rows(seed=24, S=5, F=60) if rows != "random" else \
            rd_inputs(seed=24, S=5, F=60)
        if rows == "nan":
            args = with_nans(*args)
        want = rk.rd_scan_reference(*[t(x) for x in args])
        for w, g in zip(want, lane_form_scan(*args)):
            np.testing.assert_array_equal(w.numpy(), g)

    @pytest.mark.gpu
    def test_kernel_matches_plain_on_card(self, cuda):
        packed, lp0, lg0 = rd_inputs(seed=9, S=70, F=50)
        args = [t(x).to(cuda) for x in (packed, lp0, lg0)]
        before = rk.rd_scan.launches
        got = rk.rd_scan(*args)
        assert rk.rd_scan.launches == before + 1
        want = rk.rd_scan_reference(*args)
        for w, g in zip(want, got):
            assert torch.equal(w, g)

    @pytest.mark.gpu
    @pytest.mark.parametrize("S", [1, 3, 70, 128])
    @pytest.mark.parametrize("F", [1, 7, 50, 500])
    def test_kernel_bit_exact_on_card(self, cuda, S, F):
        """Random and continuation-heavy rows, odd F (chunks that start off
        the 16-byte grid) and S off a multiple of the block's 4 streams."""
        for make in (rd_inputs, continuation_rows):
            args = [t(x).to(cuda) for x in make(seed=S + F, S=S, F=F)]
            for w, g in zip(rk.rd_scan_reference(*args), rk.rd_scan(*args)):
                assert torch.equal(w, g)

    @pytest.mark.gpu
    @pytest.mark.parametrize("offset", [1, 2, 3])
    def test_unaligned_rows_on_card(self, cuda, offset):
        """packed starting 4, 8 or 12 bytes past a 16-byte boundary."""
        packed, lp0, lg0 = continuation_rows(seed=25, S=9, F=45)
        buf = torch.empty(packed.size + offset, dtype=torch.float32, device=cuda)
        rows = buf[offset:].view(packed.shape)
        rows.copy_(t(packed))
        args = [rows, t(lp0).to(cuda), t(lg0).to(cuda)]
        for w, g in zip(rk.rd_scan_reference(*args), rk.rd_scan(*args)):
            assert torch.equal(w, g)

    @pytest.mark.gpu
    @pytest.mark.parametrize("S,F", [(3, 41), (128, 500)])
    def test_continuation_rows_bit_exact_on_card(self, cuda, S, F):
        args = [t(x).to(cuda) for x in continuation_rows(seed=26, S=S, F=F)]
        for w, g in zip(rk.rd_scan_reference(*args), rk.rd_scan(*args)):
            assert torch.equal(w, g)

    @pytest.mark.gpu
    def test_nan_rows_and_carries_on_card(self, cuda):
        args = [t(x).to(cuda) for x in with_nans(*continuation_rows(seed=27, S=6, F=70))]
        got = rk.rd_scan(*args)
        assert torch.isnan(got[0]).any()
        for w, g in zip(rk.rd_scan_reference(*args), got):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)

    @pytest.mark.gpu
    def test_repeat_launch_on_card(self, cuda):
        args = [t(x).to(cuda) for x in rd_inputs(seed=28, S=128, F=500)]
        before = rk.rd_scan.launches
        first = rk.rd_scan(*args)
        assert rk.rd_scan.launches == before + 1
        again = rk.rd_scan(*args)
        assert rk.rd_scan.launches == before + 2
        for x, y in zip(first, again):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# K3: the pitch-window gather, and the candidate gather
# ---------------------------------------------------------------------------

class TestGathers:
    @needs_jax
    def test_pitch_window_gather_matches_jax(self):
        """Exact against pallas_ops.pitch_window_gather's dynamic_slice
        branch, clamped starts included."""
        ext, starts = gather_inputs()
        want = jops.pitch_window_gather(jnp.asarray(ext), jnp.asarray(starts))
        got = ok.pitch_window_gather(t(ext), t(starts))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        np.testing.assert_array_equal(got[0, 0].numpy(), ext[0, -WIN:])
        np.testing.assert_array_equal(got[0, 1].numpy(), ext[0, :WIN])
        np.testing.assert_array_equal(got[1, -1].numpy(), ext[1, -WIN:])

    @needs_jax
    def test_rd_candidate_gather_matches_jax(self, tparams):
        rng = np.random.default_rng(4)
        S, F = 2, 7
        corr = rng.standard_normal((S, F, 385)).astype(np.float32)
        yyl = rng.random((S, F, 385)).astype(np.float32)
        T0 = rng.integers(90, 384, (S, F)).astype(np.int32)
        T0[0, :3] = [90, 383, 200]
        want = jops.rd_candidate_gather(jnp.asarray(corr), jnp.asarray(yyl), jnp.asarray(T0))
        got = ok.rd_candidate_gather(t(corr), t(yyl), t(T0), tparams["second_check"])
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())

    @pytest.mark.gpu
    def test_kernel_matches_plain_on_card(self, cuda):
        ext, starts = gather_inputs(seed=6, S=4, F=30)
        e, s = t(ext).to(cuda), t(starts).to(cuda)
        before = ok.pitch_window_gather.launches
        got = ok.pitch_window_gather(e, s)
        assert ok.pitch_window_gather.launches == before + 1
        assert torch.equal(got, ok.pitch_window_gather_reference(e, s))


class TestWrappers:
    def test_mixed_devices_raise(self):
        ext, starts = gather_inputs()
        with pytest.raises(ValueError):
            ok.pitch_window_gather(t(ext), t(starts).to("meta"))

    @pytest.mark.gpu
    def test_wrapper_rejects_bad_dtype_on_card(self, cuda):
        ext, starts = gather_inputs()
        with pytest.raises(ValueError):
            ok.pitch_window_gather(t(ext).to(cuda), t(starts).to(torch.int64).to(cuda))
