"""The port's command-line interface (graphlap_tpu_torch/cli.py) and its
timing utilities (utils/timing.py) against the reference's
(graphlap_tpu/cli.py, utils/timing.py): the same parser (every option
string, dest, default, type and choice), the same preset guard on typed
flags, the rc file and -opts_file, and a -cpu run of both CLIs on the
same 48x48 PNG (NLM 9 x 9 with the bilateral term, the dense path with the
fused kernels' plain versions, the deterministic chol solver): the output
PNGs to one 8-bit level on every pixel, the records' PSNR to 0.05 dB.
Flags whose modules are not ported raise before any work, and a run
without -cpu on a machine without a CUDA card raises and writes nothing.
"""

import json

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch import cli as tcli
from graphlap_tpu_torch.utils.timing import StageTimer, log_run, maybe_profile


@pytest.fixture(scope="module")
def jcli():
    pytest.importorskip("jax")
    from graphlap_tpu import cli
    return cli


@pytest.fixture(scope="module")
def img_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("imgs") / "in.png"
    gt.save_image(str(path), gt.make_test_image(64, 64))
    return str(path)


@pytest.fixture(autouse=True)
def no_rc_file(monkeypatch, tmp_path):
    """Neither CLI reads the home directory's rc file here."""
    monkeypatch.setattr(tcli, "RC_FILE", str(tmp_path / "absent_rc"))


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None, a.required,
                     a.nargs, a.const, type(a).__name__)
            for a in parser._actions}


def test_parser_matches_the_reference(jcli):
    assert _actions(tcli.build_parser()) == _actions(jcli.build_parser())
    assert tcli._PRESET_GUARDED_FLAGS == jcli._PRESET_GUARDED_FLAGS


@pytest.mark.parametrize("argv", [
    ["-f", "in.png", "-filter", "sharpen"],
    ["-f", "in.png", "-o", "x.png", "-preset", "fast", "-pallas"],
    ["-f", "in.png", "-sinkhorn_c", "4", "-bf", "-pal"],
    ["-f=in.png", "-h_param=0.2", "-spatial", "8", "-solv", "chol"],
    ["-f", "in.png", "--pallas", "-s", "-filter_m", "matvec", "-"],
    ["-f", "in.png", "-save_basis", "b.npz", "-gram_coarse", "8",
     "-strip_cache", "-fused_finish", "-feature_dtype", "bfloat16"],
])
def test_explicit_fields_match_the_reference(jcli, argv):
    assert tcli._explicit_fields(argv) == jcli._explicit_fields(argv)


def test_cli_opts_file(img_file, tmp_path, capsys, monkeypatch):
    """PETSc-rc-style defaults file: the file sets flags, the command line
    overrides them; the rc file is read when no -opts_file is given."""
    rc_path = tmp_path / "rc"
    rc_path.write_text("# defaults\n-kernel nlm\n-sample 0.03\n"
                       "-eigvals 24\n-noise 0.1\n")
    out = str(tmp_path / "o.png")
    rc = tcli.main(["-f", img_file, "-o", out, "-grayscale", "-cpu",
                    "-opts_file", str(rc_path), "-eigvals", "16"])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "kernel=nlm" in captured        # from the rc file
    assert "m=16" in captured              # the command line wins
    assert "PSNR noisy" in captured        # -noise from the rc file
    assert gt.load_image(out, grayscale=True).shape == (64, 64)

    assert tcli.main(["-f", img_file, "-grayscale", "-cpu",
                      f"-opts_file={rc_path}", "-eigvals", "16"]) == 0
    assert "kernel=nlm" in capsys.readouterr().out
    monkeypatch.setattr(tcli, "RC_FILE", str(rc_path))
    assert tcli.main(["-f", img_file, "-grayscale", "-cpu"]) == 0
    assert "m=24" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="opts_file"):
        tcli.main(["-f", img_file, "-opts_file"])
    with pytest.raises(SystemExit, match="opts_file"):
        tcli.main(["-f", img_file, "-opts_file="])


def test_cli_bad_flag(img_file):
    with pytest.raises(SystemExit):
        tcli.main(["-f", img_file, "-kernel", "nope"])


def test_cpu_run_matches_the_reference_cli(jcli, tmp_path, capsys,
                                          monkeypatch):
    """Both CLIs on the same 48x48 PNG: NLM 9 x 9 with the spatial term
    (83 feature lanes), -pallas on the dense path (K1's coordinate cross,
    plain on the CPU), chol: the PNGs agree to one 8-bit level, the
    records' PSNR to 0.05 dB, and the records carry the same fields."""
    monkeypatch.setattr(jcli, "RC_FILE", str(tmp_path / "absent_rc"))
    src = str(tmp_path / "in.png")
    gt.save_image(src, gt.make_test_image(48, 48))
    common = ["-f", src, "-cpu", "-grayscale", "-solver", "chol", "-kernel",
              "nlm", "-patch", "9", "-spatial_h", "8", "-pallas", "-noise",
              "0.1", "-seed", "1", "-log_view"]
    recs = {}
    for name, main in (("port", tcli.main), ("ref", jcli.main)):
        log = tmp_path / f"{name}.jsonl"
        assert main(common + ["-o", str(tmp_path / f"{name}.png"),
                              "-json_log", str(log)]) == 0
        recs[name] = json.loads(log.read_text().splitlines()[-1])
    out = capsys.readouterr().out
    assert "first call includes the kernel build" in out
    a = gt.load_image(str(tmp_path / "port.png"), grayscale=True)
    b = gt.load_image(str(tmp_path / "ref.png"), grayscale=True)
    assert a.shape == b.shape == (48, 48)
    assert float(np.abs(a - b).max()) <= 1.0 / 255 + 1e-12
    port, ref = recs["port"], recs["ref"]
    assert set(port) == set(ref)
    assert port["config_hash"] == ref["config_hash"]
    assert set(port["timings_s"]) == {"affinity", "normalize", "eigensolve",
                                      "filter"}
    assert abs(port["psnr_filtered_db"] - ref["psnr_filtered_db"]) <= 0.05


@pytest.mark.parametrize("flags,item", [
    (["-load_basis", "b.npz"], "M8"),
    (["-save_basis", "b.npz"], "M8"),
    (["-tile", "32"], "M8"),
    (["-tune_sure"], "M7"),
    (["-ds_check"], "M8"),
])
def test_unported_flags_raise_before_any_work(img_file, monkeypatch, tmp_path,
                                              flags, item):
    def no_work(*a, **k):
        raise AssertionError("work started before the refusal")

    monkeypatch.setattr(gt, "load_image", no_work)
    monkeypatch.setattr(gt, "filter_image_staged", no_work)
    out = tmp_path / "o.png"
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        tcli.main(["-f", img_file, "-cpu", "-o", str(out)] + flags)
    assert not out.exists()


def test_branches_the_reference_skips_do_not_raise():
    """-tune_sure with an explicit -h_param, and -ds_check on a normalization
    that is not Sinkhorn, skip their branch in the reference too."""
    parser = tcli.build_parser()
    for argv in (["-f", "x", "-tune_sure", "-h_param", "0.2"],
                 ["-f", "x", "-ds_check", "-normalization", "symmetric"]):
        tcli._refuse_unported(parser.parse_args(argv), argv)


def test_run_without_cpu_needs_a_card(img_file, monkeypatch, tmp_path):
    """Without -cpu the run is on the card: where there is none it raises
    before any work and writes no output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, log = tmp_path / "o.png", tmp_path / "r.jsonl"
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-f", img_file, "-o", str(out), "-json_log", str(log)])
    assert not out.exists() and not log.exists()


def test_stage_timer_log_and_profile(tmp_path):
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    with t.stage("a"):
        pass
    assert set(t.walls) == {"a", "b"}
    rep = t.report()
    assert "total" in rep and "a" in rep
    log = tmp_path / "sub" / "l.jsonl"
    log_run({"x": 1}, log)
    log_run({"x": 2}, log)
    recs = [json.loads(s) for s in log.read_text().splitlines()]
    assert [r["x"] for r in recs] == [1, 2]
    assert all("ts" in r for r in recs)
    with maybe_profile(None):
        pass
    trace = tmp_path / "trace"
    with maybe_profile(str(trace)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
