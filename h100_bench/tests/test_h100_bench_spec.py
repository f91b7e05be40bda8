"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell is found by."""

import json
import math
import re

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|experts_per_tok)")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys(section):
    for entry in SPEC[section]:
        extra = ({"workloads"} if section in ("end_to_end", "per_layer")
                 else set())
        assert ENTRY_KEYS[section] <= set(entry) <= ENTRY_KEYS[section] | extra
        assert NAME.match(entry["name"]), entry["name"]


def test_names_and_units_use_only_allowed_characters():
    names = [e["name"] for s in ENTRY_KEYS for e in SPEC[s]]
    for section in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[section]}) == len(SPEC[section])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for name in names:
        assert NAME.match(name), name
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["bench"]["source"] == c["source"]
        assert config["bench"]["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)


def test_published_configs_are_copied_unchanged():
    # The frozen files are this repository's copies whole; ``reduced``
    # names what those copies and the benchmark's data change from the
    # upstream files.
    for c in SPEC["configs"]:
        published = json.loads(
            (ROOT / "config" / f"{c['name']}.json").read_text())
        ours = json.loads((ROOT / c["file"]).read_text())
        for key, value in published.items():
            assert ours[key] == value, key


def test_cells_are_one_chip_and_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert 1 <= len(SPEC["workloads"]) <= 24
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in SPEC["per_layer"])


def test_per_layer_workloads_and_moves_are_consistent():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert "workloads" in m and set(m["workloads"]) <= cells
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            # A kernel's share of its roofline: ``<kernel>_roofline``.
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_finds_its_files():
    for w in SPEC["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "traffic" / f"{traffic['generator']}.py").is_file()
        limits = json.loads((BENCH / "checks" / f"{w['name']}.json")
                            .read_text())["limits"]
        assert limits and all(math.isfinite(v) and v >= 0
                              for v in limits.values())
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_nothing_under_paths_names_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"dpft_tpu)(\s|\.|$)", re.M)
    for path in BENCH.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
