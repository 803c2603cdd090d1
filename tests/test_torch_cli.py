"""The port's CLI (python -m regex_fpga_tpu_torch) against the JAX
package's (python -m regex_fpga_tpu) on the same temporary files: every
subcommand through both ``main`` functions in this process, the port's with
``--device cpu``. Tolerance: none; standard output, standard error, return
codes and written files must be equal, except the wall-clock fields of
``scan``'s metrics line."""

import json

import pytest
import torch

from regex_fpga_tpu.__main__ import main as jmain
from regex_fpga_tpu_torch.__main__ import main as tmain

TEXT = b"alpha 42 beta 7 gamma 3.14 GET /index.php HTTP/1.1 user=99 foo bar"
RULES_FILE = (
    'alert tcp any any -> any 80 (msg:"cmd.exe access"; content:"cmd.exe"; '
    'nocase; sid:1002;)\n'
    'alert tcp any any -> any 80 (msg:"with pcre"; content:"user="; '
    'pcre:"/user=[0-9]+/"; sid:6000;)\n'
    'alert tcp any any -> any any (msg:"outside"; content:"GET"; '
    'pcre:"/GET/x"; sid:7000;)\n'
    'alert tcp any any -> any any (msg:"dce"; content:"X"; '
    'byte_test:1,>,2,0,dce; sid:8000;)\n'
)


@pytest.fixture
def files(tmp_path):
    f = {
        "text": tmp_path / "input.txt", "clean": tmp_path / "clean.txt",
        "traffic": tmp_path / "traffic.bin", "rules": tmp_path / "t.rules",
        "regex_rules": tmp_path / "rules.txt", "mixed": tmp_path / "mixed.txt",
        "empty": tmp_path / "empty.txt", "pats": tmp_path / "pats.txt",
        "mem": tmp_path / "trace.mem",
    }
    f["text"].write_bytes(TEXT)
    f["clean"].write_bytes(b"totally pristine\n")
    f["traffic"].write_bytes(b"GET /scripts/CMD.EXE?/c dir HTTP/1.0 user=99 X\x09")
    f["rules"].write_text(RULES_FILE)
    f["regex_rules"].write_bytes(b"# c\nfoo+\nba[rz]\n[0-9]+\\.[0-9]+\n")
    f["mixed"].write_bytes(b"^foo\nbar\n")
    f["empty"].write_bytes(b"# nothing\n\n")
    f["pats"].write_bytes(b"# pats\nbeta\nHTTP\n")
    f["mem"].write_text("".join(f"{b:02x}\n" for b in TEXT * 3))
    return {k: str(v) for k, v in f.items()}


def run(main, argv, capsys):
    """(return code, stdout, stderr); an exception stands for the return
    code as its type's name (the port words some messages differently)."""
    try:
        rc = main(argv)
    except Exception as e:  # noqa: BLE001 -- compared with the other CLI's
        rc = type(e).__name__
    out, err = capsys.readouterr()
    return rc, out, err


def assert_same(argv, capsys):
    got = run(tmain, argv + ["--device", "cpu"], capsys)
    want = run(jmain, argv, capsys)
    assert got == want
    return got


CASES = {
    "grep": lambda f: ["grep", r"[0-9]+", f["text"], f["clean"]],
    "grep-none": lambda f: ["grep", r"zzz[0-9]", f["text"]],
    "grep-host": lambda f: ["grep", r"\bbeta\b", f["text"]],
    "grep-count": lambda f: ["grep", "-c", r"[0-9]+", f["text"], f["clean"]],
    "grep-count-none": lambda f: ["grep", "-c", r"zzz", f["clean"]],
    "acgrep": lambda f: ["acgrep", "-e", "GET ", "-f", f["pats"], f["text"]],
    "acgrep-none": lambda f: ["acgrep", "-e", "zzz", f["text"]],
    "rgrep": lambda f: ["rgrep", "-e", r"user=[0-9]+", "-e", r"GET /[a-z]+",
                        "-e", r"^alpha", f["text"], f["clean"]],
    "rgrep-no-prefilter": lambda f: ["rgrep", "--no-prefilter", "-e",
                                     r"zzz[0-9]", f["clean"]],
    "rgrep-file": lambda f: ["rgrep", "-f", f["regex_rules"], f["text"]],
    "rgrep-nothing": lambda f: ["rgrep", f["text"]],
    "snort": lambda f: ["snort", f["rules"], f["traffic"], f["text"]],
    "snort-clean": lambda f: ["snort", f["rules"], f["clean"]],
    "snort-no-files": lambda f: ["snort", f["rules"]],
    "snort-coverage": lambda f: ["snort", f["rules"], "--coverage"],
    "snort-partial": lambda f: ["snort", f["rules"], "--coverage",
                                "--partial-only"],
    "scan-mem": lambda f: ["scan", "--coe", f["coe"], f["mem"]],
    "scan-full": lambda f: ["scan", "--coe", f["coe"], "--full", f["mem"],
                            f["text"]],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(case, files, capsys, tmp_path):
    files["coe"] = str(tmp_path / "r.coe")
    if case.startswith("scan"):
        assert jmain(["compile-rules", files["regex_rules"], "-o",
                      files["coe"]]) == 0
        capsys.readouterr()
        got = run(tmain, CASES[case](files) + ["--device", "cpu"], capsys)
        want = run(jmain, CASES[case](files), capsys)
        assert got[0] == want[0] == 0 and got[2] == want[2]
        g, w = got[1].splitlines(), want[1].splitlines()
        assert g[:-1] == w[:-1]
        gj, wj = json.loads(g[-1]), json.loads(w[-1])
        for timing in ("wall_seconds", "bytes_per_second"):
            gj.pop(timing), wj.pop(timing)
        assert gj == wj and gj["total"] > 0
        return
    rc, out, _ = assert_same(CASES[case](files), capsys)
    assert rc in (0, 1, 2) or case == "grep-host"


@pytest.mark.parametrize("extra", [[], ["--scan", "text"]])
def test_cli_compile_rules_matches_jax(files, capsys, tmp_path, extra):
    extra = [files.get(a, a) for a in extra]
    got = run(tmain, ["compile-rules", files["regex_rules"], "-o",
                      str(tmp_path / "t.coe"), *extra, "--device", "cpu"], capsys)
    want = run(jmain, ["compile-rules", files["regex_rules"], "-o",
                       str(tmp_path / "t.coe"), *extra], capsys)
    assert got[0] == want[0] == 0 and got[2] == want[2]
    assert got[1] == want[1]
    assert (tmp_path / "t.coe").stat().st_size > 0
    tbytes = (tmp_path / "t.coe").read_bytes()
    assert jmain(["compile-rules", files["regex_rules"], "-o",
                  str(tmp_path / "j.coe")]) == 0
    assert tbytes == (tmp_path / "j.coe").read_bytes()
    capsys.readouterr()
    for bad in ("mixed", "empty"):
        assert_same(["compile-rules", files[bad], "-o",
                     str(tmp_path / "x.coe")], capsys)


def test_cli_snort_export_coe_matches_jax(files, capsys, tmp_path):
    for who, main, extra in (("t", tmain, ["--device", "cpu"]),
                             ("j", jmain, [])):
        rc = main(["snort", files["rules"], "--export-coe",
                   str(tmp_path / f"{who}.coe"), *extra])
        assert rc == 0
    out_t = (tmp_path / "t.coe").read_bytes()
    assert out_t == (tmp_path / "j.coe").read_bytes()
    capsys.readouterr()
    assert_same(["snort", files["rules"], files["traffic"], "--export-coe",
                 str(tmp_path / "both.coe")], capsys)


@pytest.mark.parametrize("kind,n", [("snort", 50), ("l7", 12)])
def test_cli_gen_corpus_matches_jax(tmp_path, capsys, kind, n):
    got = run(tmain, ["gen-corpus", kind, str(tmp_path / "t"), "-n", str(n)],
              capsys)
    want = run(jmain, ["gen-corpus", kind, str(tmp_path / "j"), "-n", str(n)],
               capsys)
    assert got[0] == want[0] == 0
    assert got[2].replace(str(tmp_path / "t"), "X") == \
        want[2].replace(str(tmp_path / "j"), "X")
    if kind == "snort":
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    else:
        names = sorted(p.name for p in (tmp_path / "j").iterdir())
        assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
        for name in names:
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes()


def test_cli_presplit_matches_jax(files, capsysbinary):
    assert tmain(["--device", "cpu", "presplit", files["text"]]) == 0
    got = capsysbinary.readouterr().out
    assert jmain(["presplit", files["text"]]) == 0
    assert got == capsysbinary.readouterr().out
    assert got.count(b"\n") > 10


def test_cli_conformance_without_fixtures(tmp_path, capsys, monkeypatch):
    """Without the reference fixtures the port says so and exits 1; the JAX
    CLI stops on the missing file (exit code 1 as a process)."""
    monkeypatch.setenv("REGEX_FPGA_REFERENCE", str(tmp_path / "missing"))
    assert tmain(["conformance", "--device", "cpu"]) == 1
    assert "no reference fixtures" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        jmain(["conformance"])


def test_cli_needs_a_card_unless_told(files, monkeypatch, capsys):
    """Without --device the CLI builds its matchers on the card, and raises
    when none is visible; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["grep", "x", files["text"]], ["grep", "-c", "x", files["text"]],
                 ["acgrep", "-e", "x", files["text"]],
                 ["rgrep", "-e", "x", files["text"]],
                 ["snort", files["rules"], files["text"]],
                 ["snort", files["rules"], "--coverage"],
                 ["presplit", files["text"]],
                 ["--device", "cuda", "grep", "x", files["text"]]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmain(argv)
    assert tmain(["--device", "cpu", "grep", "-c", "a", files["text"]]) == 0
    assert capsys.readouterr().out == f"{files['text']}:6\n"
