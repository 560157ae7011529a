"""``kernels/build.py``'s split build, on the CPU with a stand-in ``nvcc``
that records its arguments and writes an empty file where ``-o`` points.

A source in ``build.SPLIT`` compiles as one ``nvcc -c -D<MACRO>=i`` per
unit, all started at once, then one link of the objects into the
library; every other source is one ``nvcc -shared``.
"""

import json

import pytest

from megatron_llm_tpu_torch.kernels import build

RECORDING_NVCC = """#!/bin/sh
printf '%s\\n' "$*" >> "{log}"
case "$*" in *slow.cu*) sleep 2;; esac
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "whole.cu").write_text("// a kernel\n")
    (csrc / "parts.cu").write_text("// one instantiation a PARTS_UNIT\n")
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(RECORDING_NVCC.format(log=calls))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "SPLIT", {"parts": ("PARTS_UNIT", 3)})
    return calls


def test_split_source_compiles_its_units_then_links_one_library(tree):
    build.build_all(names=("whole", "parts"))
    calls = tree.read_text().splitlines()
    units = [c for c in calls if "-DPARTS_UNIT=" in c]
    assert sorted(c.split("-DPARTS_UNIT=")[1][0] for c in units) == \
        ["0", "1", "2"]
    assert all(" -c " in f" {c} " and "-shared" not in c for c in units)
    links = [c for c in calls if "-shared" in c and "parts" in c
             and "PARTS_UNIT" not in c]
    assert len(links) == 1 and links[0].count(".o") == 3
    whole = [c for c in calls if "whole.cu" in c]
    assert len(whole) == 1 and "-shared" in whole[0]
    assert build._target("parts").exists()
    assert build._target("whole").exists()
    # the objects are gone, each unit's seconds and the whole are kept
    assert not list(build._target("parts").parent.glob("*.o"))
    assert {"parts", "parts.0", "parts.1", "parts.2", "whole"} <= \
        set(build.NVCC_SECONDS)
    json.dumps(build.NVCC_SECONDS)


def test_split_seconds_are_its_own_not_the_slowest_builds(tree, tmp_path):
    """A split source's seconds run to its last unit's end plus its link,
    not to the end of a slower build started beside it."""
    (tmp_path / "csrc" / "slow.cu").write_text("// a long kernel\n")
    build.build_all(names=("slow", "parts"))
    secs = build.NVCC_SECONDS
    assert secs["slow"] >= 2.0
    assert secs["parts"] < 0.5 * secs["slow"]
    assert secs["parts"] >= max(secs[f"parts.{i}"] for i in range(3))


def test_split_build_is_current_after_one_run(tree):
    build.build_all(names=("parts",))
    n = len(tree.read_text().splitlines())
    build.build_all(names=("parts",))
    assert len(tree.read_text().splitlines()) == n


def test_the_fused_decode_step_is_split():
    """``decode_step.cu`` names its units with ``DECODE_STEP_PART``: four
    instantiations and the C interface; without the macro it does not
    compile."""
    assert build.SPLIT["decode_step"] == ("DECODE_STEP_PART", 5)
    src = (build.CSRC / "decode_step.cu").read_text()
    guard = src.index("#ifndef DECODE_STEP_PART")
    assert src[guard:].split("\n")[1].startswith("#error")
    for i in range(5):
        assert f"DECODE_STEP_PART == {i}" in src


def test_flash_decode_is_split():
    """``flash_decode.cu`` names its units with ``FLASH_DECODE_PART``: one a
    kernel (K8-K11, each with every dtype, head dim and group) and the C
    interface, which dispatches to the parts; without the macro it does
    not compile.  A probe's copy of it (``flash_decode_<variant>.cu``)
    splits the same way."""
    assert build.SPLIT["flash_decode"] == ("FLASH_DECODE_PART", 5)
    src = (build.CSRC / "flash_decode.cu").read_text()
    guard = src.index("#ifndef FLASH_DECODE_PART")
    assert src[guard:].split("\n")[1].startswith("#error")
    for i in range(5):
        assert f"FLASH_DECODE_PART == {i}" in src
    interface = src[src.index("#if FLASH_DECODE_PART == 4"):]
    for i, launcher in enumerate(("flash_decode_launch",
                                  "flash_decode_int8_launch",
                                  "flash_decode_paged_launch",
                                  "flash_decode_paged_int8_launch")):
        body = interface[interface.index(f'extern "C" int {launcher}('):]
        body = body[:body.index("\n}\n")]
        assert f"flash_decode_part{i}(&a," in body, launcher
