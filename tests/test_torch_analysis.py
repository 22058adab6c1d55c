"""The port's simlint (``repro_torch.analysis``) against the reference's.

The reference's unit tests for the rules the port keeps (every rule but
SL102 and SL103, which match only JAX APIs), run on the port's linter;
each known-bad and known-good snippet of them gives the same findings in
both packages, as does every test module that does not mention torch; the
torch forms of SL101, SL105 and SL109; the command line's ``--check``,
``--baseline``, ``--write-baseline``, ``--rules`` and ``--root``; baseline
files written by either package read the same in the other; and the
port's own source and entry points scan clean (the port's counterpart of
the reference's CI lint step)."""

import pathlib
import textwrap

import pytest

import repro.analysis as ref_analysis
from repro.analysis import baseline as ref_baseline
from repro.analysis.cli import main as ref_cli_main
from repro_torch.analysis import check_paths, check_source
from repro_torch.analysis.baseline import diff_baseline, load_baseline, write_baseline
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.engine import iter_py_files
from repro_torch.analysis.rules import all_rules, rules_by_id

REPO = pathlib.Path(__file__).resolve().parents[1]
KEPT = ("SL101", "SL104", "SL105", "SL106", "SL107", "SL108", "SL109",
        "SL110", "SL111")

# (rule, known-bad?, source, pretend path): the snippets of
# tests/test_analysis.py for the kept rules, by that file's test names
SNIPPETS = {
    "SL101-flags_global_rng": ("SL101", True, """
        import numpy as np
        x = np.random.uniform(0, 1, 100)
    """, "core/snippet.py"),
    "SL101-allows_default_rng": ("SL101", False, """
        import numpy as np
        rng = np.random.default_rng(0)
        seq = np.random.SeedSequence([1, 2])
        x = rng.uniform(0, 1, 100)
    """, "core/snippet.py"),
    "SL104-flags_for_over_set_literal": ("SL104", True, """
        for node in {3, 1, 2}:
            emit(node)
    """, "core/snippet.py"),
    "SL104-flags_list_of_set_call": ("SL104", True, """
        order = list(set(xs))
    """, "core/snippet.py"),
    "SL104-allows_sorted_set": ("SL104", False, """
        for node in sorted({3, 1, 2}):
            emit(node)
        order = sorted(set(xs))
    """, "core/snippet.py"),
    "SL105-flags_subscript_store": ("SL105", True, """
        def f(batch):
            batch.sizes[0] = 0
    """, "core/snippet.py"),
    "SL105-flags_inplace_sort": ("SL105", True, """
        def f(scores):
            scores.percentage.sort()
    """, "core/snippet.py"),
    "SL105-allows_copy_then_mutate": ("SL105", False, """
        def f(batch):
            sizes = batch.sizes.copy()
            sizes[0] = 0
            srt = np.sort(scores.percentage)
    """, "core/snippet.py"),
    "SL106-flags_assert": ("SL106", True, """
        def f(pipeline):
            assert pipeline.flush_job is not None
    """, "core/snippet.py"),
    "SL106-allows_raise": ("SL106", False, """
        def f(pipeline):
            if pipeline.flush_job is None:
                raise RuntimeError("no active flush job")
    """, "core/snippet.py"),
    "SL107-flags_cross_family_assign": ("SL107", True, """
        total_bytes = elapsed_seconds
    """, "core/snippet.py"),
    "SL107-flags_cross_family_add": ("SL107", True, """
        budget = wait_seconds + backlog_bytes
    """, "core/snippet.py"),
    "SL107-allows_same_family_and_converted": ("SL107", False, """
        total_bytes = region_bytes + overflow_bytes
        wall_seconds = io_seconds + gap_seconds
        total_mb = used_bytes / 1e6
    """, "core/snippet.py"),
    "SL108-flags_core_entry_point_without_contract": ("SL108", True, """
        def run_replay(trace):
            \"\"\"Replays the trace.\"\"\"
            return trace
    """, "core/engine.py"),
    "SL108-ignores_non_core_modules": ("SL108", False, """
        def run_replay(trace):
            \"\"\"Replays the trace.\"\"\"
            return trace
    """, "service/loop.py"),
    "SL108-allows_documented_contract": ("SL108", False, """
        def run_replay(trace):
            \"\"\"Replay; bit-identical to the per-request oracle.\"\"\"
            return trace
    """, "core/engine.py"),
    "SL109-flags_list_default": ("SL109", True, """
        def f(x, acc=[]):
            acc.append(x)
            return acc
    """, "core/snippet.py"),
    "SL109-allows_none_default": ("SL109", False, """
        def f(x, acc=None):
            acc = [] if acc is None else acc
            acc.append(x)
            return acc
    """, "core/snippet.py"),
    "SL110-flags_bare_except": ("SL110", True, """
        try:
            risky()
        except:
            pass
    """, "core/snippet.py"),
    "SL110-flags_swallowed_exception": ("SL110", True, """
        try:
            risky()
        except Exception:
            pass
    """, "core/snippet.py"),
    "SL110-allows_handled_exception": ("SL110", False, """
        try:
            risky()
        except ValueError:
            pass
        try:
            risky()
        except Exception as e:
            log(e)
    """, "core/snippet.py"),
    "SL111-flags_cached_method": ("SL111", True, """
        import functools

        class Sim:
            @functools.lru_cache(maxsize=8)
            def score(self, n):
                return n * n
    """, "core/snippet.py"),
    "SL111-allows_module_level_cache": ("SL111", False, """
        import functools

        @functools.lru_cache(maxsize=8)
        def score(n):
            return n * n

        class Sim:
            @staticmethod
            def helper(n):
                return score(n)
    """, "core/snippet.py"),
}


def findings_for(rule_id: str, source: str, rel: str = "core/snippet.py"):
    rules = rules_by_id([rule_id])
    return check_source(textwrap.dedent(source), rules=rules, rel=rel)


def assert_flags(rule_id: str, source: str, rel: str = "core/snippet.py"):
    found = findings_for(rule_id, source, rel)
    assert found, f"{rule_id} missed a known-bad snippet"
    assert all(f.rule == rule_id for f in found)
    return found


def assert_clean(rule_id: str, source: str, rel: str = "core/snippet.py"):
    found = findings_for(rule_id, source, rel)
    assert not found, f"{rule_id} false positive: {[f.render() for f in found]}"


# -- engine mechanics ----------------------------------------------------


def test_inline_suppression():
    src = "def f(x):\n    assert x  # simlint: disable=SL106\n"
    assert check_source(src, rules=rules_by_id(["SL106"])) == []
    # a different rule id does not suppress
    src2 = "def f(x):\n    assert x  # simlint: disable=SL101\n"
    assert len(check_source(src2, rules=rules_by_id(["SL106"]))) == 1


def test_suppress_all():
    src = "def f(x):\n    assert x  # simlint: disable=all\n"
    assert check_source(src) == []


def test_fingerprint_is_line_independent():
    a = check_source("def f(x):\n    assert x\n")
    b = check_source("\n\n\ndef f(x):\n    assert x\n")
    assert a[0].line != b[0].line
    assert a[0].fingerprint == b[0].fingerprint


def test_rules_by_id_rejects_unknown():
    with pytest.raises(ValueError, match="unknown rule"):
        rules_by_id(["SL999"])


def test_registry_has_at_least_eight_distinct_rules():
    ids = [r.id for r in all_rules()]
    assert len(ids) == len(set(ids))
    assert len(ids) >= 8


def test_iter_py_files_rejects_non_python(tmp_path):
    f = tmp_path / "data.json"
    f.write_text("{}")
    with pytest.raises(ValueError, match="not a .py file"):
        iter_py_files([f])


# -- CLI -----------------------------------------------------------------


@pytest.mark.parametrize("source,rc,said", [
    ("def f(x):\n    assert x\n", 1, "SL106"),
    ("def f(x):\n    return x\n", 0, "simlint: clean"),
], ids=["finding", "clean"])
def test_cli_check(tmp_path, capsys, source, rc, said):
    mod = tmp_path / "mod.py"
    mod.write_text(source)
    assert cli_main(["--check", str(mod)]) == rc
    assert said in capsys.readouterr().out


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "SL106" in out and "load-bearing-assert" in out


def test_cli_requires_check(capsys):
    assert cli_main([]) == 2


# -- baseline ------------------------------------------------------------


def test_baseline_round_trip_and_diff(tmp_path):
    findings = check_source("def f(x):\n    assert x\n    assert not x\n")
    assert len(findings) == 2
    path = tmp_path / "baseline.json"
    write_baseline(path, findings)
    counts = load_baseline(path)
    assert sum(counts.values()) == 2

    # same findings: nothing new, nothing stale
    new, stale = diff_baseline(findings, counts)
    assert new == [] and stale == []

    # one fixed: it shows up as stale
    new, stale = diff_baseline(findings[:1], counts)
    assert new == [] and len(stale) == 1

    # a fresh finding is reported as new
    extra = check_source("def g(y):\n    assert y\n")
    new, stale = diff_baseline(findings + extra, counts)
    assert len(new) == 1


def test_baseline_rejects_bad_schema(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"schema": "nope/v9", "fingerprints": {}}')
    with pytest.raises(ValueError, match="unknown baseline schema"):
        load_baseline(path)


def test_cli_check_and_baseline_flow(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text("def f(x):\n    assert x\n")

    assert cli_main(["--check", str(bad)]) == 1
    assert "SL106" in capsys.readouterr().out

    baseline = tmp_path / "baseline.json"
    assert cli_main(
        ["--check", str(bad), "--write-baseline", str(baseline)]
    ) == 0
    capsys.readouterr()
    # baselined: clean exit
    assert cli_main(["--check", str(bad), "--baseline", str(baseline)]) == 0
    assert "clean" in capsys.readouterr().out

    # fixing the file makes the baseline entry stale -> nonzero, so the
    # baseline cannot rot silently
    bad.write_text("def f(x):\n    return x\n")
    assert cli_main(["--check", str(bad), "--baseline", str(baseline)]) == 1
    assert "stale" in capsys.readouterr().out


def _as_reference(out: str) -> str:
    """The port's command-line output as the reference words it: SL106's
    message names each package's own sanitizer."""

    return out.replace("repro_torch.analysis", "repro.analysis")


# a module whose SL106 and SL101 findings both linters report alike
_SHARED_SOURCE = ("import numpy as np\n\n\ndef f(x):\n    assert x\n"
                  "    return np.random.uniform(0, 1, 3)\n")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_baselines_are_shared(writer, tmp_path, capsys):
    """A baseline written by either package's command line gives the other
    the same ``(new, stale)`` split, file for file, and the same verdict."""

    mod = tmp_path / "mod.py"
    mod.write_text(_SHARED_SOURCE)
    path = tmp_path / "baseline.json"
    write, read = (cli_main, ref_cli_main) if writer == "port" else (ref_cli_main, cli_main)
    assert write(["--check", str(mod), "--root", str(tmp_path),
                  "--write-baseline", str(path)]) == 0
    assert "wrote 2 finding(s)" in capsys.readouterr().out
    port_counts, ref_counts = load_baseline(path), ref_baseline.load_baseline(path)
    assert port_counts == ref_counts and sum(port_counts.values()) == 2
    assert read(["--check", str(mod), "--root", str(tmp_path), "--baseline", str(path)]) == 0
    assert capsys.readouterr().out == "simlint: clean\n"

    # one finding fixed, one new: the same split under both packages
    mod.write_text(_SHARED_SOURCE.replace("    assert x\n", "") + "\n\ndef g(y):\n"
                   "    assert y\n")
    port_new, port_stale = diff_baseline(check_paths([mod], root=tmp_path), port_counts)
    ref_new, ref_stale = ref_baseline.diff_baseline(
        ref_analysis.check_paths([mod], rules=ref_analysis.rules_by_id(KEPT), root=tmp_path),
        ref_counts)
    assert _key(port_new, True) == _key(ref_new, False) and len(port_new) == 1
    assert port_stale == ref_stale == ["SL106::mod.py::assert x"]
    outs = []
    for main in (cli_main, ref_cli_main):
        assert main(["--check", str(mod), "--root", str(tmp_path), "--rules", ",".join(KEPT),
                     "--baseline", str(path)]) == 1
        outs.append(capsys.readouterr().out)
    assert _as_reference(outs[0]) == outs[1]
    assert "stale baseline entry (fixed — remove it): SL106::mod.py::assert x" in outs[0]
    assert outs[0].endswith("simlint: 1 new finding(s), 1 stale baseline entr(y/ies)\n")


@pytest.mark.parametrize("rules,said", [
    ("SL106", ["SL106"]), ("sl101, SL106", ["SL106", "SL101"]), ("SL104", [])],
    ids=["one", "two", "none-found"])
def test_cli_rules_runs_only_the_named_rules(rules, said, tmp_path, capsys):
    mod = tmp_path / "mod.py"
    mod.write_text(_SHARED_SOURCE)
    rc = cli_main(["--check", str(mod), "--rules", rules])
    out = capsys.readouterr().out
    assert rc == (1 if said else 0)
    assert [line.split()[1] for line in out.splitlines() if ": SL" in line] == said
    assert ref_cli_main(["--check", str(mod), "--rules", rules]) == rc
    assert capsys.readouterr().out == _as_reference(out)


@pytest.mark.parametrize("rule", ["SL102", "SL103", "SL999"])
def test_cli_rules_refuses_an_unknown_id(rule, tmp_path):
    """SL102 and SL103 match JAX APIs and are not in the port's registry,
    so ``--rules`` names them unknown, as the reference does SL999."""

    mod = tmp_path / "mod.py"
    mod.write_text(_SHARED_SOURCE)
    with pytest.raises(ValueError, match="unknown rule"):
        cli_main(["--check", str(mod), "--rules", rule])


def test_cli_root_reports_paths_relative_to_it(tmp_path, capsys, monkeypatch):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(_SHARED_SOURCE)
    monkeypatch.chdir(REPO)
    assert cli_main(["--check", str(pkg), "--root", str(tmp_path)]) == 1
    lines = [line for line in capsys.readouterr().out.splitlines() if ": SL" in line]
    assert lines and all(line.startswith("pkg/mod.py:") for line in lines)
    assert cli_main(["--check", str(pkg), "--root", str(pkg)]) == 1
    assert all(line.startswith("mod.py:") for line in capsys.readouterr().out.splitlines()
               if ": SL" in line)


# -- the port against the reference -------------------------------------


def _key(findings, port: bool):
    """(rule, name, line, code, message) of each finding; SL106's message
    names each package's own sanitizer, so the port's is mapped back."""

    out = []
    for f in findings:
        message = f.message
        if port and f.rule == "SL106":
            message = message.replace("repro_torch.analysis", "repro.analysis")
        out.append((f.rule, f.name, f.line, f.code, message))
    return out


@pytest.mark.parametrize("key", sorted(SNIPPETS))
def test_snippet_findings_equal_the_reference(key):
    """Every kept rule over the snippet: the same findings, line for line,
    as the reference's linter running the same rules; and the snippet's
    own rule flags it or passes it as its reference test expects."""

    rule, bad, source, rel = SNIPPETS[key]
    (assert_flags if bad else assert_clean)(rule, source, rel)
    src = textwrap.dedent(source)
    port = check_source(src, rel=rel)
    ref = ref_analysis.check_source(src, rules=ref_analysis.rules_by_id(KEPT), rel=rel)
    assert _key(port, True) == _key(ref, False)


def test_findings_equal_the_reference_on_source_without_torch():
    """The reference's test modules (asserts, set literals, NumPy draws):
    every module that does not mention torch gives the port's linter the
    reference's findings, finding for finding."""

    paths = [p for p in sorted((REPO / "tests").glob("test_*.py"))
             if "torch" not in p.read_text()]
    assert len(paths) > 20
    port = check_paths(paths, root=REPO)
    ref = ref_analysis.check_paths(paths, rules=ref_analysis.rules_by_id(KEPT), root=REPO)
    assert port and _key(port, True) == _key(ref, False)


def test_rule_ids_names_and_descriptions_follow_the_reference():
    ref = {r.id: r for r in ref_analysis.all_rules()}
    assert tuple(r.id for r in all_rules()) == KEPT
    for rule in all_rules():
        assert rule.name == ref[rule.id].name
    for absent in ("SL102", "SL103"):
        assert absent in ref
        with pytest.raises(ValueError, match="unknown rule"):
            rules_by_id([absent])


def test_cli_lists_exactly_the_kept_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    ids = [line.split()[0] for line in capsys.readouterr().out.splitlines()
           if line.startswith("SL")]
    assert ids == list(KEPT)


# -- the torch forms of the same hazards ---------------------------------


TORCH_FORMS = [
    ("SL101", True, "import torch\nx = torch.randn(3, 4)\n"),
    ("SL101", True, "import torch\nx = torch.randint(0, 9, (4,), device='cuda')\n"),
    ("SL101", True, "import torch\ny = torch.rand_like(x)\n"),
    ("SL101", True, "import torch\ntorch.manual_seed(0)\n"),
    ("SL101", True, "import torch\ntorch.cuda.manual_seed_all(0)\n"),
    ("SL101", False, "import torch\ng = torch.Generator()\nx = torch.randn(3, 4, generator=g)\n"),
    ("SL101", False, "import torch\ng = torch.Generator().manual_seed(3)\n"),
    ("SL101", False, "import torch\ng = torch.Generator(device='cuda').manual_seed(3)\n"
                     "p = torch.randperm(8, generator=g, device='cuda')\n"),
    ("SL101", True, "import torch\ny = torch.randint_like(x, 9)\n"),
    ("SL101", False, "import torch\ny = torch.randint_like(x, 9, generator=g)\n"),
    ("SL101", True, "import torch\ny = torch.poisson(rates)\n"),
    ("SL101", False, "import torch\ny = torch.poisson(rates, generator=g)\n"),
    ("SL101", True, "import torch\nw = torch.empty(4, 4)\nw.normal_(0.0, 0.02)\n"),
    ("SL101", False, "import torch\nw = torch.empty(4, 4)\nw.normal_(0.0, 0.02, generator=g)\n"),
    ("SL101", True, "def f(w):\n    w.uniform_(-1, 1)\n"),
    ("SL101", False, "def f(w, g):\n    w.uniform_(-1, 1, generator=g)\n"),
    ("SL101", True, "def f(m):\n    m.weight.data.random_(0, 9)\n"),
    ("SL101", True, "def f(w):\n    w.bernoulli_(0.5)\n"),
    ("SL101", True, "def f(w):\n    w.exponential_()\n"),
    ("SL101", False, "def f(w, g):\n    w.exponential_(generator=g)\n"),
    ("SL101", True, "import torch\ntorch.nn.init.xavier_uniform_(w)\n"),
    ("SL101", False, "import torch\ntorch.nn.init.xavier_uniform_(w, generator=g)\n"),
    ("SL101", True, "from torch import nn\nnn.init.kaiming_normal_(w)\n"),
    ("SL101", False, "import torch\ntorch.nn.init.zeros_(w)\ntorch.nn.init.constant_(w, 0.5)\n"),
    ("SL105", True, "def f(batch):\n    batch.offsets.fill_(0)\n"),
    ("SL105", True, "def f(batch, t):\n    batch.sizes.copy_(t)\n"),
    ("SL105", True, "def f(scores, i, v):\n    scores.rf_sum.index_put_((i,), v)\n"),
    ("SL105", False, "def f(batch):\n    x = batch.offsets.clone()\n    x.fill_(0)\n"),
    ("SL105", False, "def f(batch):\n    n = batch.offsets.__len__()\n"),
    ("SL109", True, "import torch\ndef f(x=torch.zeros(3)):\n    return x\n"),
    ("SL109", True, "import torch\ndef f(*, x=torch.tensor([1])):\n    return x\n"),
    ("SL109", False, "import torch\ndef f(x=None):\n    return torch.zeros(3) if x is None else x\n"),
]


@pytest.mark.parametrize("rule,bad,source", TORCH_FORMS,
                         ids=[f"{r}-{'bad' if b else 'good'}{i}"
                              for i, (r, b, _) in enumerate(TORCH_FORMS)])
def test_torch_forms(rule, bad, source):
    (assert_flags if bad else assert_clean)(rule, source)


# -- the gate: the port itself scans clean -------------------------------


def test_src_repro_torch_is_simlint_clean():
    findings = check_paths([REPO / "src" / "repro_torch", REPO / "chip_smoke.py",
                            REPO / "chip_memory_probe.py", REPO / "chip_stream_variants.py",
                            REPO / "chip_replay_compare.py", REPO / "examples_torch",
                            REPO / "experiments" / "anomaly_hunt_torch.py"],
                           root=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)
