"""The harness finds cells, configurations, mixes, metrics and the code
they name (drivers, families, generators) by name, as files: a new file
dropped into a folder is picked up, and every name in ``BENCHMARK.json``
has its files."""
import json
import shutil

import pytest

from portbench import catalog

BENCH = catalog.benchmark()


def test_every_benchmark_entry_has_its_files():
    for c in BENCH["configs"]:
        assert (catalog.REPO / c["file"]).is_file()
        assert catalog.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = catalog.workload(w["name"])
        assert {k: cell[k] for k in w} == w
        fam = catalog.family(catalog.config(cell["config"])["family"])
        assert callable(fam.served_gaps) and callable(fam.draw)
        assert callable(fam.decode_token_flops)
        gen = catalog.generator(catalog.mix(cell["traffic"])["generator"])
        assert callable(gen.requests)
        assert callable(catalog.driver(cell["driver"]).run)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(catalog.metric_reader(m["name"]))


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in catalog.cell_metrics(BENCH, w["name"],
                                                       False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.cell_metrics(BENCH, w["name"], True)


def test_new_workload_file_is_found_by_name(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(catalog.HERE / "workloads", root / "workloads")
    cell = catalog.workload("qwen2.5-3b.serve.chat", root)
    cell.update(name="qwen2.5-3b.serve.slow-chat", why="a test's cell")
    cell["traffic_params"]["rate_per_s"] = 1.0
    (root / "workloads" / "qwen2.5-3b.serve.slow-chat.json").write_text(
        json.dumps(cell))
    assert "qwen2.5-3b.serve.slow-chat" in catalog.workload_names(root)
    got = catalog.workload("qwen2.5-3b.serve.slow-chat", root)
    assert got["traffic_params"]["rate_per_s"] == 1.0
    # a per-layer metric without a workloads list follows the end-to-end
    # metric it moves into the new cell
    bench = {"end_to_end": [{"name": "setup_s"}, {"name": "tpot_p95_ms"}],
             "per_layer": [{"name": "x.chat", "moves": "tpot_p95_ms"},
                           {"name": "y", "moves": "out_tok_s",
                            "workloads": ["other"]}]}
    names = [m["name"] for m in catalog.cell_metrics(
        bench, "qwen2.5-3b.serve.slow-chat", True)]
    assert names == ["x.chat"]


def test_new_metric_file_is_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "answer.test.py").write_text(
        "def read(rec):\n    return 42.0\n")
    assert catalog.metric_reader("answer.test", tmp_path)(None) == 42.0


@pytest.mark.parametrize("folder", ["generators", "families", "drivers"])
def test_new_code_file_is_found_by_name(tmp_path, folder):
    (tmp_path / folder).mkdir()
    (tmp_path / folder / "burst-test.py").write_text("ANSWER = 42\n")
    load = {"generators": catalog.generator, "families": catalog.family,
            "drivers": catalog.driver}[folder]
    assert load("burst-test", tmp_path).ANSWER == 42


@pytest.mark.parametrize("bad", ["../x", "a/b", "", "a b"])
def test_names_that_are_not_names_are_refused(bad):
    with pytest.raises(ValueError):
        catalog.workload(bad)
