"""Nothing the harness loads has the top-level name jax, jaxlib, flax or
repro (the JAX package; `repro_torch` is compared whole and allowed), and
the harness reads nothing under benchmarks/."""

import re
import subprocess
import sys

import pbtest

SOURCES = sorted(p for p in pbtest.HERE.rglob("*.py") if "tests" not in p.parts)


def test_sources_import_no_jax_and_read_no_old_benchmarks():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)(\s|\.|$)", re.M)
    for p in SOURCES:
        text = p.read_text()
        assert not pat.search(text), p
        assert "benchmarks/" not in text and '"benchmarks"' not in text, p


def test_a_cpu_query_and_its_reference_load_no_jax():
    code = f"""
import sys
sys.path[:0] = [{str(pbtest.HERE)!r}, {str(pbtest.ROOT / 'src')!r}]
from bench import cell, port, reference, spec, timeline, check, hooks, peaks
bench = spec.benchmark()
for name in ("job1.frontier", "job1.general"):
    wl = spec.workload(bench, name)
    trf = spec.traffic(wl["traffic"]); trf.update(n_jobs=8, m_trials=2)
    model = spec.model(spec.config(bench, wl["config"]), trf)
    port.entry(model, "cpu")(3)
    reference.query(model, 3, "cpu")
print("forbidden=" + ",".join(cell.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden="


def test_reference_imports_nothing_of_the_program():
    text = (pbtest.HERE / "bench" / "reference.py").read_text()
    assert "repro_torch" not in text.replace("`repro_torch", "")
    assert not re.search(r"^\s*(import|from)\s+\S*repro", text, re.M)
