"""The port's readers of the decomposition products on the CPU, against
the JAX package: the walker bootstrap (``decompose.echo_cos_matrix``,
``bootstrap_*``), the record store (``io.record``), the record readers
(``open_record``, ``record_params``, ``reconstruct_record``) and the rest
of ``analysis`` (the CPMG rate, the T2 spectrum, the CSV fits and
``main``, the ``mri-t2-fit`` command line).

All of it is float64 NumPy carried over as it is, so on the same inputs
the two packages agree to rounding: bootstrap samples at rtol 1e-12
with ``n_ok`` equal, echo matrices and reconstructions at 1e-12, the
spectra at 1e-12, and ``main`` writes the same ``--out-table`` text.
The one float32 path, ``reconstruct_record`` at the moment scales alone
(``curves_at_scales``: torch in the port, XLA in JAX), is held at 1e-6.

The record is a seeded one with a decaying echo envelope: 200 windows x
256 walkers, A drifting by 0.1 a window and B by 0.02 (T2 ~ 0.7 ms).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from mri_nanoparticle_simulation_tpu import analysis as jan
from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu.engine import decompose as jdec
from mri_nanoparticle_simulation_tpu.io import record as jrec
from mri_nanoparticle_simulation_tpu_torch import analysis as tan
from mri_nanoparticle_simulation_tpu_torch.engine import convert
from mri_nanoparticle_simulation_tpu_torch.engine import decompose as tdec
from mri_nanoparticle_simulation_tpu_torch.io import record as trec

EXACT = dict(rtol=1e-12, atol=1e-12)


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


@pytest.fixture(scope="module")
def record():
    p = JP.small_test_params(num_water=256, totaltime=0.02,
                             sprint_steps=2000, taucp=0.001)
    g = np.random.default_rng(19)
    n = p.t // p.pfreq
    a = np.cumsum(g.normal(0.0, 0.1, (n, 256)), 0).astype(np.float32)
    b = np.cumsum(g.normal(0.0, 0.02, (n, 256)), 0).astype(np.float32)
    return p, _tp(p), a, b


def _assert_boot_equal(ours, theirs):
    assert ours.n_ok == theirs.n_ok
    np.testing.assert_allclose(ours.t2_samples, theirs.t2_samples,
                               rtol=1e-12)
    assert tuple(ours.fit) == tuple(theirs.fit)
    for k in ("t2_lo_ms", "t2_hi_ms", "t2_stderr_ms"):
        np.testing.assert_allclose(getattr(ours, k), getattr(theirs, k),
                                   rtol=1e-12)


# -- the walker bootstrap --------------------------------------------------------

@pytest.mark.parametrize("scale,taucp,block", [(1.0, None, 1024),
                                               (0.5, 0.002, 7),
                                               (2.0, 0.0005, 100)])
def test_echo_cos_matrix_matches_jax(record, scale, taucp, block):
    p, tp, a, b = record
    te, ce = tdec.echo_cos_matrix(a, b, tp, scale=scale, taucp=taucp,
                                  walker_block=block)
    je, cj = jdec.echo_cos_matrix(a, b, p, scale=scale, taucp=taucp)
    np.testing.assert_array_equal(te, je)
    assert ce.shape == (te.size, 256)
    np.testing.assert_allclose(ce, cj, **EXACT)


@pytest.mark.parametrize("scale,taucp", [(1.0, None), (0.5, 0.002)])
def test_bootstrap_t2_matches_jax(record, scale, taucp):
    p, tp, a, b = record
    ours = tdec.bootstrap_t2(a, b, tp, scale=scale, taucp=taucp, n_boot=32,
                             seed=1)
    theirs = jdec.bootstrap_t2(a, b, p, scale=scale, taucp=taucp, n_boot=32,
                               seed=1)
    assert ours.n_ok > 16 and ours.t2_lo_ms < ours.fit.t2_ms < ours.t2_hi_ms
    _assert_boot_equal(ours, theirs)


def test_bootstrap_from_echoes_matches_jax(record):
    p, tp, a, b = record
    te, ce = jdec.echo_cos_matrix(a, b, p)
    _assert_boot_equal(
        tdec.bootstrap_from_echoes(te, ce, n_boot=40, seed=3, ci=0.9),
        jdec.bootstrap_from_echoes(te, ce, n_boot=40, seed=3, ci=0.9))


def test_bootstrap_dispersion_matches_jax(record):
    """One row a taucp; the spacing with no echo inside the record gets
    the nan row of both."""
    p, tp, a, b = record
    taucps = [0.0005, 0.001, 0.002, p.totaltime]
    ours = tdec.bootstrap_dispersion(a, b, tp, taucps, n_boot=24, seed=2)
    theirs = jdec.bootstrap_dispersion(a, b, p, taucps, n_boot=24, seed=2)
    assert [r["taucp_ms"] for r in ours] == taucps
    assert ours[-1]["n_ok"] == 0 and np.isnan(ours[-1]["t2_ms"])
    assert all(r["n_ok"] > 0 for r in ours[:-1])
    for r, s in zip(ours, theirs):
        assert r.keys() == s.keys()
        np.testing.assert_allclose([r[k] for k in r], [s[k] for k in s],
                                   rtol=1e-12)


@pytest.mark.parametrize("case", ["ci", "n_boot", "no_echo"])
def test_bootstrap_guards_match_jax(record, case):
    p, tp, a, b = record
    kw = {"ci": dict(n_boot=8, ci=1.5), "n_boot": dict(n_boot=1),
          "no_echo": dict(n_boot=8, taucp=p.totaltime)}[case]
    with pytest.raises(ValueError) as ours:
        tdec.bootstrap_t2(a, b, tp, **kw)
    with pytest.raises(ValueError) as theirs:
        jdec.bootstrap_t2(a, b, p, **kw)
    assert str(ours.value) == str(theirs.value)


# -- the record store and the record readers -----------------------------------

def _npz(path, p, a, b):
    np.savez_compressed(path, times_ms=np.arange(1, len(a) + 1) * p.pfreq
                        * p.tau, A=a, B=b, mmoment=p.mmoment, seed=5,
                        taucp=p.taucp, tau=p.tau, pfreq=p.pfreq)
    return str(path)


def _store(mod, path, p, a, b, finalize=True):
    st = mod.RecordStore.create(str(path), a.shape[0], a.shape[1],
                                extra_meta={"taucp": p.taucp, "tau": p.tau,
                                            "pfreq": p.pfreq, "seed": 5})
    for lo in range(0, a.shape[0], 30):
        st.update(a[lo:lo + 30], b[lo:lo + 30])
    if finalize:
        st.finalize()
    return str(path)


@pytest.mark.parametrize("writer_mod,reader_mod", [(trec, jrec), (jrec, trec)],
                         ids=["port_to_jax", "jax_to_port"])
def test_record_store_across_packages(tmp_path, record, writer_mod,
                                      reader_mod):
    p, _, a, b = record
    path = _store(writer_mod, tmp_path / "rec", p, a, b)
    assert reader_mod.is_record_dir(path)
    st = reader_mod.RecordStore.open(path)
    assert (st.rows, st.n_windows, st.num_water, st.complete) == \
        (200, 200, 256, True)
    ra, rb = st.arrays()
    np.testing.assert_array_equal(ra, a)
    np.testing.assert_array_equal(rb, b)
    np.testing.assert_array_equal(st.times_ms(),
                                  np.arange(1, 201) * p.pfreq * p.tau)


def test_record_store_files_written_alike(tmp_path, record):
    p, _, a, b = record
    t = _store(trec, tmp_path / "t", p, a, b)
    j = _store(jrec, tmp_path / "j", p, a, b)
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    with open(os.path.join(t, "meta.json")) as ft, \
            open(os.path.join(j, "meta.json")) as fj:
        assert json.load(ft) == json.load(fj)


@pytest.mark.parametrize("case", ["overflow", "shape", "read_only",
                                  "finalize_early", "exists", "version"])
def test_record_store_errors_match_jax(tmp_path, record, case):
    p, _, a, b = record

    def run(mod, d):
        if case == "exists":
            _store(mod, d, p, a, b)
            mod.RecordStore.create(str(d), 200, 256)
        st = mod.RecordStore.create(str(d), 200, 256)
        st.append(a[:60], b[:60])
        st = mod.RecordStore.open(str(d), writable=case != "read_only")
        if case == "overflow":
            st.append(np.zeros((141, 256)), np.zeros((141, 256)))
        elif case == "shape":
            st.append(np.zeros((2, 255)), np.zeros((2, 255)))
        elif case == "read_only":
            st.append(a[:1], b[:1])
        elif case == "finalize_early":
            st.finalize()
        elif case == "version":
            meta = os.path.join(str(d), "meta.json")
            with open(meta) as f:
                m = json.load(f)
            m["version"] = 99
            with open(meta, "w") as f:
                json.dump(m, f)
            mod.RecordStore.open(str(d))

    with pytest.raises((ValueError, FileExistsError)) as ours:
        run(trec, tmp_path / "t")
    with pytest.raises((ValueError, FileExistsError)) as theirs:
        run(jrec, tmp_path / "j")
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value).replace(str(tmp_path / "t"), "D") == \
        str(theirs.value).replace(str(tmp_path / "j"), "D")


def test_run_decomposition_writes_a_store(tmp_path):
    """A store is a run_decomposition consumer: the port's run writes it
    and JAX reads the same record the run returns without one."""
    p = JP.small_test_params(num_water=64, mmoment=2e-14,
                             avoid_intracellular_throw=False)
    tp = _tp(p)
    from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox
    sc = BacteriaBox(tp, seed=3).populate()
    st = trec.RecordStore.create(str(tmp_path / "rec"), tp.t // tp.pfreq,
                                 64, extra_meta={"taucp": tp.taucp,
                                                 "tau": tp.tau,
                                                 "pfreq": tp.pfreq})
    tdec.run_decomposition(sc, tp, seed=5, device="cpu", consumer=st)
    st.finalize()
    ref = tdec.run_decomposition(sc, tp, seed=5, device="cpu")
    a, b, meta = jdec.open_record(str(tmp_path / "rec"))
    np.testing.assert_array_equal(a, ref.A)
    np.testing.assert_array_equal(b, ref.B)
    np.testing.assert_array_equal(meta["times_ms"], ref.times_ms)


@pytest.fixture(params=["npz", "store"])
def saved(request, tmp_path, record):
    p, tp, a, b = record
    if request.param == "npz":
        return _npz(tmp_path / "rec.npz", p, a, b)
    return _store(trec, tmp_path / "rec", p, a, b)


def test_open_record_matches_jax(saved):
    ta, tb, tm = tdec.open_record(saved)
    ja, jb, jm = jdec.open_record(saved)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    assert tm.keys() == jm.keys()
    for k in tm:
        if isinstance(jm[k], np.ndarray):
            np.testing.assert_array_equal(tm[k], jm[k])
        else:
            assert tm[k] == jm[k] and type(tm[k]) is type(jm[k]), k


def test_record_params_match_jax(saved):
    tp, jp = tdec.record_params(saved), jdec.record_params(saved)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (tp.t, tp.pfreq, tp.tcp) == (jp.t, jp.pfreq, jp.tcp)


@pytest.mark.parametrize("how", ["scales", "plane", "schedules"])
def test_reconstruct_record_matches_jax(saved, how):
    kw = {"scales": {}, "plane": {"taucps": [0.0005, 0.001, 0.002]},
          "schedules": {"schedules": [[], [10, 30, 55], [7]]}}[how]
    ours = tdec.reconstruct_record(saved, [0.5, 1.0], quadrature=True, **kw)
    theirs = jdec.reconstruct_record(saved, [0.5, 1.0], quadrature=True,
                                     **kw)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-6 if how == "scales" else 1e-12)


@pytest.mark.parametrize("fn", ["t2", "dispersion"])
def test_bootstrap_records_match_jax(saved, fn):
    if fn == "t2":
        _assert_boot_equal(
            tdec.bootstrap_t2_record(saved, n_boot=16, seed=4),
            jdec.bootstrap_t2_record(saved, n_boot=16, seed=4))
        return
    ours = tdec.bootstrap_dispersion_record(saved, [0.001, 0.002], n_boot=16)
    theirs = jdec.bootstrap_dispersion_record(saved, [0.001, 0.002],
                                              n_boot=16)
    assert ours == theirs


@pytest.mark.parametrize("case", ["incomplete", "no_knobs", "both_axes"])
def test_record_reader_errors_match_jax(tmp_path, record, case):
    p, _, a, b = record

    def run(dec, d):
        os.makedirs(d)
        if case == "incomplete":
            dec.open_record(_store(trec, os.path.join(d, "s"), p, a, b,
                                   finalize=False))
        elif case == "no_knobs":
            path = os.path.join(d, "r.npz")
            np.savez(path, A=a, B=b)
            dec.record_params(path)
        else:
            dec.reconstruct_record(_npz(os.path.join(d, "r.npz"), p, a, b),
                                   [1.0], taucps=[0.001], schedules=[[]])

    with pytest.raises(ValueError) as ours:
        run(tdec, str(tmp_path / "t"))
    with pytest.raises(ValueError) as theirs:
        run(jdec, str(tmp_path / "j"))
    assert str(ours.value).replace(str(tmp_path / "t"), "D") == \
        str(theirs.value).replace(str(tmp_path / "j"), "D")


# -- the rest of analysis --------------------------------------------------------

def test_nnls_matches_jax():
    g = np.random.default_rng(5)
    for m, n in ((30, 8), (50, 40), (20, 64)):
        a = g.random((m, n))
        y = a @ np.where(g.random(n) < 0.3, g.random(n), 0.0) \
            + g.normal(0, 1e-3, m)
        np.testing.assert_array_equal(tan._nnls(a, y), jan._nnls(a, y))


def _biexp(seed=2, n=400):
    g = np.random.default_rng(seed)
    t = np.arange(1, n + 1) * 0.05
    return t, 0.7 * np.exp(-t / 1.5) + 0.3 * np.exp(-t / 9.0) \
        + g.normal(0, 2e-3, n)


@pytest.mark.parametrize("kw", [{}, {"lambda_reg": 0.05},
                                {"n_t2": 16, "t2_min_ms": 0.2,
                                 "t2_max_ms": 50.0, "chi2_factor": 1.0}],
                         ids=["default", "lambda", "grid"])
def test_fit_t2_spectrum_matches_jax(kw):
    t, y = _biexp()
    ours, theirs = tan.fit_t2_spectrum(t, y, **kw), jan.fit_t2_spectrum(
        t, y, **kw)
    assert ours._fields == theirs._fields
    for f in ours._fields:
        np.testing.assert_allclose(np.asarray(getattr(ours, f), float),
                                   np.asarray(getattr(theirs, f), float),
                                   **EXACT, err_msg=f)
    assert len(ours.peaks) >= 1


def test_cpmg_rate_and_design_match_jax():
    p = JP.small_test_params(b0_gradient=(1e-4, 0.0, 2e-4), taucp=0.001)
    tp = _tp(p)
    assert tan.carr_purcell_r2(tp) == jan.carr_purcell_r2(p)
    assert tan.carr_purcell_r2(tp, D=1.5) == jan.carr_purcell_r2(p, D=1.5)
    r2 = tan.carr_purcell_r2(tp)
    assert tan.design_gradient_for_r2(tp, r2) == \
        jan.design_gradient_for_r2(p, r2)
    np.testing.assert_allclose(tan.design_gradient_for_r2(tp, r2),
                               np.hypot(1e-4, 2e-4), rtol=1e-12)
    with pytest.raises(ValueError, match="r2_per_ms must be >= 0"):
        tan.design_gradient_for_r2(tp, -1.0)


def _csv(path, quadrature=True):
    t, y = _biexp(n=300)
    cols = [t, 32 * y] + ([32 * 0.1 * y] if quadrature else [])
    np.savetxt(path, np.stack(cols, 1), delimiter=",", fmt="%.17g")
    return str(path)


@pytest.mark.parametrize("kw", [{}, {"taucp_ms": 0.1},
                                {"magnitude": True}, {"floor": 0.1}])
def test_csv_fits_match_jax(tmp_path, kw):
    path = _csv(tmp_path / "t2.csv")
    assert tuple(tan.fit_t2_csv(path, **kw)) == tuple(jan.fit_t2_csv(path,
                                                                     **kw))
    kw.pop("floor", None)
    a, b = tan.fit_t2_spectrum_csv(path, **kw), jan.fit_t2_spectrum_csv(
        path, **kw)
    np.testing.assert_allclose(a.weights, b.weights, **EXACT)


def test_magnitude_needs_the_sin_column(tmp_path):
    path = _csv(tmp_path / "t2.csv", quadrature=False)
    for fn in ("fit_t2_csv", "fit_t2_spectrum_csv"):
        with pytest.raises(ValueError) as ours:
            getattr(tan, fn)(path, magnitude=True)
        with pytest.raises(ValueError) as theirs:
            getattr(jan, fn)(path, magnitude=True)
        assert str(ours.value) == str(theirs.value)


# -- main (mri-t2-fit) ---------------------------------------------------------

@pytest.fixture
def inputs(tmp_path, record):
    p, _, a, b = record
    caps = [tdec.EchoCapture(scale=s, taucp_ms=p.taucp, times_ms=te, cos=ce)
            for s in (1.0, 2.0)
            for te, ce in [tdec.echo_cos_matrix(a, b, _tp(p), scale=s)]]
    caps.append(tdec.EchoCapture(scale=1.0, taucp_ms=1.0,
                                 times_ms=np.array([2.0]),
                                 cos=np.full((1, 16), 0.5)))
    echoes = str(tmp_path / "e.npz")
    tdec.save_echoes(echoes, caps, seed=3)
    return {"csv": _csv(tmp_path / "t2.csv"), "echoes": echoes,
            "npz": _npz(tmp_path / "rec.npz", p, a, b),
            "store": _store(trec, tmp_path / "store", p, a, b)}


MAINS = {
    "csv": ["{csv}"],
    "csv_echo_envelope": ["{csv}", "--taucp", "0.1", "--magnitude"],
    "spectrum": ["{csv}", "--spectrum", "--spectrum-bins", "32",
                 "--out-table", "{out}"],
    "echoes": ["--echoes", "{echoes}", "--bootstrap", "24", "--seed", "1",
               "--out-table", "{out}"],
    "echoes_ci": ["--echoes", "{echoes}", "--bootstrap", "16", "--ci",
                  "0.8", "--floor", "0.05", "--out-table", "{out}"],
    "record": ["--record", "{npz}", "--bootstrap", "16", "--scale", "0.5"],
    "record_dir": ["--record", "{store}", "--bootstrap", "16", "--taucp",
                   "0.002"],
    "taucp_grid": ["--record", "{npz}", "--taucp-grid",
                   "0.0005,0.001,0.002,0.02", "--bootstrap", "16",
                   "--out-table", "{out}"],
    "taucp_grid_dir": ["--record", "{store}", "--taucp-grid",
                       "0.001,0.002", "--bootstrap", "12", "--seed", "7",
                       "--out-table", "{out}"],
    "csv_and_echoes": ["{csv}", "--echoes", "{echoes}", "--bootstrap",
                       "8"],
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_matches_jax(tmp_path, inputs, capsys, name):
    """Both packages' main on the same inputs: the same exit code, the
    same printed lines (but the table's path) and the same table text."""
    outs = {}
    for tag, mod in (("port", tan), ("jax", jan)):
        out = str(tmp_path / f"{tag}.csv")
        argv = [a.format(out=out, **inputs) for a in MAINS[name]]
        assert mod.main(argv) == 0
        text = open(out).read() if os.path.exists(out) else None
        outs[tag] = (capsys.readouterr().out.replace(out, "OUT"), text)
    assert outs["port"] == outs["jax"]
    if "{out}" in MAINS[name]:
        assert outs["port"][1].count("\n") >= 2
    if name == "echoes":
        rows = outs["port"][1].splitlines()
        assert rows[0] == ("mscale,taucp_ms,r2_per_ms,t2_ms,t2_lo_ms,"
                           "t2_hi_ms,t2_stderr_ms,n_ok")
        assert rows[-1].endswith(",nan,nan,nan,nan,nan,0")   # one echo


GUARDS = {
    "nothing": [],
    "grid_without_record": ["{csv}", "--taucp-grid", "0.001"],
    "out_table_alone": ["{csv}", "--out-table", "x.csv"],
    "spectrum_and_record": ["--spectrum", "--record", "{npz}"],
    "spectrum_without_csv": ["--spectrum"],
    "spectrum_table_of_two": ["{csv}", "{csv}", "--spectrum",
                              "--out-table", "x.csv"],
    "taucp_not_positive": ["{csv}", "--taucp", "0"],
    "magnitude_without_csv": ["--record", "{npz}", "--magnitude"],
    "echo_bootstrap_of_one": ["--echoes", "{echoes}", "--bootstrap", "1"],
    "record_bootstrap_of_one": ["--record", "{npz}", "--bootstrap", "1"],
    "grid_bootstrap_of_one": ["--record", "{npz}", "--taucp-grid", "0.001",
                              "--bootstrap", "1"],
    "grid_not_numbers": ["--record", "{npz}", "--taucp-grid", "0.001,x"],
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_main_guards_match_jax(inputs, capsys, name):
    """The same flags fail the same way in both (tests/test_analysis.py:
    240-345): exit 2 with the same message."""
    argv = [a.format(**inputs) for a in GUARDS[name]]
    msgs = []
    for mod in (tan, jan):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1].split(
            "error: ", 1)[1])
    assert msgs[0] == msgs[1]


def test_main_refuses_a_non_echo_file(tmp_path):
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, A=np.zeros((2, 2)))
    msgs = []
    for mod in (tan, jan):
        with pytest.raises(ValueError, match="echo-capture") as e:
            mod.main(["--echoes", bad])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_analysis_runs_as_a_module(tmp_path, inputs):
    import subprocess
    import sys
    out = str(tmp_path / "t.csv")
    r = subprocess.run(
        [sys.executable, "-m", "mri_nanoparticle_simulation_tpu_torch."
         "analysis", "--echoes", inputs["echoes"], "--bootstrap", "8",
         "--out-table", out], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr
    assert "echo-bootstrap table written" in r.stdout
    assert len(open(out).read().splitlines()) == 4
