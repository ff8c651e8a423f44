"""The port's CUDA sources as files, checked on the CPU (no nvcc, no card):
the build hash covers the shared header of every source that includes it
(K1's forward and backward beside it, K4's backward through the include
path) and no header a source leaves out, and every planted fault of
``tools/flash_attention_mutants.py`` and ``tools/decode_ssd_mutants.py``
and every edit of ``tools/k1_bwd_variants.py`` and
``tools/ssd_bwd_variants.py`` still finds its text in the sources, so
neither the stale-library guard nor those tools can rot silently.
"""
import importlib.util
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
SSD_CSRC = ROOT / "src" / "repro_torch" / "kernels" / "ssd_scan" / "csrc"
HEADER = "hopper_sm90.cuh"


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load_tool("flash_attention_mutants")
VARIANTS = _load_tool("k1_bwd_variants")
DECODE_SSD = _load_tool("decode_ssd_mutants")
SSD_VARIANTS = _load_tool("ssd_bwd_variants")
MUTANT_CASES = [(table, name) for table in ("MUTANTS", "BWD_MUTANTS")
                for name in getattr(TOOL, table)]


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of K1's sources and the shared header, searched for includes
    in place of the package's, beside a copy of K4's sources."""
    copy = Path(shutil.copytree(CSRC, tmp_path / "csrc"))
    shutil.copytree(SSD_CSRC, tmp_path / "ssd_csrc")
    monkeypatch.setattr(_build, "INCLUDE_DIRS", (copy,))
    return copy


@pytest.mark.parametrize("source", ["flash_attention_fwd.cu",
                                    "flash_attention_bwd.cu",
                                    "ssd_scan_bwd.cu"])
def test_editing_the_shared_header_changes_the_library(csrc_copy, source):
    src = csrc_copy / source
    if not src.exists():                  # K4's backward: not beside the header
        src = csrc_copy.parent / "ssd_csrc" / source
    assert f'#include "{HEADER}"' in src.read_text()
    assert _build.included_headers(src) == [(csrc_copy / HEADER).resolve()]
    before = _build.source_hash(src)
    hdr = csrc_copy / HEADER
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _build.source_hash(src) != before


@pytest.mark.parametrize("where", ["beside K4", "beside the shared header"])
def test_editing_a_header_no_source_includes_leaves_k4(csrc_copy, where):
    """A header that K4's backward does not include, beside it or in the
    include path, is not in its hash; nor is the shared header in the hash
    of a source that does not include it (K4's forward)."""
    ssd = csrc_copy.parent / "ssd_csrc"
    bwd, fwd = ssd / "ssd_scan_bwd.cu", ssd / "ssd_scan_fwd.cu"
    before = _build.source_hash(bwd), _build.source_hash(fwd)
    other = (ssd if where == "beside K4" else csrc_copy) / "unused.cuh"
    other.write_text("#pragma once\n")
    other.write_text(other.read_text() + "// edited\n")
    assert (_build.source_hash(bwd), _build.source_hash(fwd)) == before
    hdr = csrc_copy / HEADER
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _build.source_hash(fwd) == before[1]
    assert _build.source_hash(bwd) != before[0]


def test_editing_another_source_leaves_the_library(csrc_copy):
    src = csrc_copy / "flash_attention_bwd.cu"
    before = _build.source_hash(src)
    fwd = csrc_copy / "flash_attention_fwd.cu"
    fwd.write_text(fwd.read_text() + "\n// edited\n")
    assert _build.source_hash(src) == before
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.source_hash(src) != before


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_library_path_names_the_source_hash(name):
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR
    assert path.name == f"{name}-{_build.source_hash(_build.SOURCES[name])}.so"


@pytest.mark.parametrize("table,name", MUTANT_CASES)
def test_mutant_text_occurs_once(table, name):
    file, edits = getattr(TOOL, table)[name]
    text = (CSRC / file).read_text()
    assert edits
    for old, new in edits:
        assert old != new
        assert text.count(old) == 1, f"{name}: {old!r}"
    assert TOOL.mutated(file, edits) != text


def test_mutant_copies_differ_from_the_sources_in_one_file(tmp_path):
    jobs = TOOL.write_mutants(tmp_path)
    assert set(jobs) == set(TOOL.MUTANTS) | set(TOOL.BWD_MUTANTS)
    for name, (kind, src, lib) in jobs.items():
        table = TOOL.MUTANTS if kind == "fwd" else TOOL.BWD_MUTANTS
        assert src.name == f"{TOOL.LIBS[kind][0]}.cu"
        assert lib.parent == src.parent and lib.suffix == ".so"
        changed = [f.name for f in src.parent.iterdir()
                   if f.read_text() != (CSRC / f.name).read_text()]
        assert changed == [table[name][0]]


@pytest.mark.parametrize("name", sorted(VARIANTS.VARIANTS))
def test_k1_bwd_variant_edits_apply_once(name, tmp_path):
    kind, edits = VARIANTS.VARIANTS[name]
    assert kind in ("design", "ablation") and edits
    text = (CSRC / VARIANTS.SOURCE).read_text()
    for old, new in edits:
        assert old != new
        assert text.count(old) == 1, f"{name}: {old[:60]!r}"
    (src, lib), = VARIANTS.write_variants(tmp_path, [name]).values()
    assert src.read_text() != text and (src.parent / HEADER).exists()
    assert lib.parent == src.parent


@pytest.mark.parametrize("name", sorted(DECODE_SSD.MUTANTS))
def test_decode_ssd_mutant_texts_are_in_their_sources(name):
    """Every fault ``tools/decode_ssd_mutants.py`` plants (K3, K4, K4's
    backward, K2a) finds its text exactly once in its library's source."""
    lib, old, new = DECODE_SSD.MUTANTS[name]
    assert old != new
    assert _build.SOURCES[lib].read_text().count(old) == 1


@pytest.mark.parametrize("name", sorted(SSD_VARIANTS.VARIANTS))
def test_ssd_bwd_variant_edits_apply_once(name, tmp_path):
    """Every ablation of ``tools/ssd_bwd_variants.py`` edits K4 backward's
    source where it means to: each text found exactly once."""
    text = SSD_VARIANTS.SOURCE.read_text()
    for old, new in SSD_VARIANTS.VARIANTS[name]:
        assert old != new
        assert text.count(old) == 1, f"{name}: {old[:60]!r}"
    (src, lib), = SSD_VARIANTS.write_variants(tmp_path, [name]).values()
    assert src.read_text() != text and lib.parent == src.parent
