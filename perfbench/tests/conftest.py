"""Each test of the benchmark ends with the program's recorder off: loading
a reader of the program's sections (`bench/spans.py`) enables it, and the
tests after would otherwise run the program with recording on."""

import pytest

import pbtest  # noqa: F401  (the harness's import path)


@pytest.fixture(autouse=True)
def _recording_off():
    yield
    from repro_torch import obs

    obs.disable()
