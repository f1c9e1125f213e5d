"""A configuration, a traffic mix and a per-layer metric are added as new
files and new manifest entries, and nothing else changes."""

import json
import shutil

from perfbench.registry import Registry
from perfbench.run import execute
from perfbench.tests.tiny import TINY, tiny_run


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    bench = tmp_path / "perfbench"
    shutil.copytree(Registry().bench, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "tests"))
    manifest = json.loads((Registry().root / "BENCHMARK.json").read_text())
    # a configuration
    cfg = json.loads((bench / "configs" / "paper128.json").read_text())
    cfg["name"] = "paper48_added"
    cfg["config"].update(TINY, inference_mode="independent")
    (bench / "configs" / "paper48_added.json").write_text(json.dumps(cfg))
    manifest["configs"].append({"name": "paper48_added", "source": "x",
                                "file": "perfbench/configs/"
                                        "paper48_added.json",
                                "reduced": [], "why": "a test"})
    # a traffic mix
    (bench / "traffic" / "train_b2_added.json").write_text(json.dumps(
        {"kind": "train", "overrides": {"batch_size": 2,
                                        "compute_dtype": "float32"},
         "warmup_calls": 1, "profile_steps": 1}))
    cell = "train.paper48_added.b2"
    manifest["workloads"].append({"name": cell, "config": "paper48_added",
                                  "traffic": "train_b2_added", "chips": 1,
                                  "why": "a test"})
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(
        json.loads((bench / "limits" / "train.paper128.b128.json")
                   .read_text())))
    # a per-layer metric, and the end-to-end metric it moves
    (bench / "layer_metrics" / "steps_added.train.py").write_text(
        "def read(record):\n    return float(record['steps'])\n")
    manifest["per_layer"].append({"name": "steps_added.train",
                                  "unit": "steps", "better": "higher",
                                  "source": "program_counter",
                                  "layer": "train step",
                                  "moves": "train_img_s",
                                  "workloads": [cell]})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    reg = Registry(root=tmp_path, bench=bench)
    assert reg.config("paper48_added")["name"] == "paper48_added"
    assert [m["name"] for m in reg.per_layer(cell)] == ["steps_added.train"]
    assert {m["name"] for m in reg.end_to_end(cell)} == {"train_img_s",
                                                         "setup_s"}
    for trace in (False, True):
        _, r, limits = tiny_run(cell, registry=reg, batch=2,
                                 trace=trace)
        assert r.fields["inference_mode"] == "independent"
        result, rows = execute(reg, r, limits)
        assert result["correct"], rows
        if trace:
            assert result["metrics"]["steps_added.train"]["value"] >= 1
        else:
            assert set(result["metrics"]) == {"train_img_s", "setup_s"}
    # the cells of the manifest itself are untouched by the new entries
    assert reg.per_layer("train.paper128.b128") == \
        Registry().per_layer("train.paper128.b128")
