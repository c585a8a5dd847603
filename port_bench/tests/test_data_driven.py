"""A configuration, a traffic mix, a per-layer metric, a kind of traffic and
a model family are found by name from files alone: adding each is new files
and new BENCHMARK.json entries, with no file of the harness edited."""

import json

import port_bench.kinds
import port_bench.models
from port_bench import cells, compare, run, spec
from port_bench.tests.conftest import REPO


def test_a_new_cell_config_and_metric_from_files_alone(tmp_path, tiny_f32, capsys):
    bench = json.loads((tiny_f32 / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_f32 / "cfg" / "anomaly_unet_b64_256.json").read_text())
    cfg["image_height"] = cfg["image_width"] = 48
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "anomaly_48.json").write_text(json.dumps(cfg))
    (tmp_path / "port_bench" / "traffic").mkdir(parents=True)
    traffic = json.loads((tiny_f32 / "port_bench/traffic/closed_loop_serve_int8_b128.json")
                         .read_text())
    traffic["batch"] = 2
    (tmp_path / "port_bench/traffic/new_mix.json").write_text(json.dumps(traffic))
    for name in ("anomaly_unet_b64_256",):
        (tmp_path / "cfg" / f"{name}.json").write_text(
            (tiny_f32 / "cfg" / f"{name}.json").read_text())
    bench["configs"].append({"name": "anomaly_48", "source": "https://arxiv.org/abs/1505.04597",
                             "file": "cfg/anomaly_48.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new_cell", "config": "anomaly_48",
                               "traffic": "new_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("new_cell")
    bench["end_to_end"][-1].pop("workloads", None)
    metric_dir = tmp_path / "metrics"
    metric_dir.mkdir()
    (metric_dir / "images.new.py").write_text("def read(ctx):\n    return ctx.traced.images\n")
    bench["per_layer"].append({"name": "images.new", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "serve_img_per_s", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("new_cell", tmp_path)
    assert cell.config["image_height"] == 48 and cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["images.new"]
    c = cells.make(cell.config, cell.traffic, 5, "cpu")
    c.start_program()
    record = c.run(0.2)
    c.stop_program()
    ctx = run.Context(cell.config, cell.traffic, record, record, None)
    assert spec.reader("images.new", metric_dir)(ctx) == record.images > 0


def test_a_new_kind_and_family_from_files_alone(tmp_path, tiny_f32, monkeypatch):
    kinds, families = tmp_path / "kinds", tmp_path / "models"
    kinds.mkdir()
    families.mkdir()
    (kinds / "serve_twice.py").write_text(
        "from port_bench.kinds.serve import Cell as _Serve\n\n\n"
        "class Cell(_Serve):\n"
        "    def _request(self):\n"
        "        super()._request()\n"
        "        return super()._request()\n")
    (families / "anomaly_copy.py").write_text(
        "from port_bench.models.anomaly_unet import *  # noqa\n")
    monkeypatch.setattr(port_bench.kinds, "__path__", [*port_bench.kinds.__path__, str(kinds)])
    monkeypatch.setattr(port_bench.models, "__path__",
                        [*port_bench.models.__path__, str(families)])
    cfg = json.loads((tiny_f32 / "cfg" / "anomaly_unet_b64_256.json").read_text())
    cfg["family"] = "anomaly_copy"
    traffic = json.loads((tiny_f32 / "port_bench/traffic/closed_loop_serve_int8_b128.json")
                         .read_text())
    traffic.update(kind="serve_twice", batch=2, checked_requests=2)
    c = cells.make(cfg, traffic, 5, "cpu")
    assert type(c).__module__ == "port_bench.kinds.serve_twice"
    assert c.family.__name__ == "port_bench.models.anomaly_copy"
    c.start_program()
    record = c.run(0.2)
    c.stop_program()
    assert record.requests > 0 and c.k == 2 * (traffic["warmup_requests"] + record.requests)
    ok, _ = compare.verdict(c.check(), traffic["limits"])
    assert ok


def test_every_file_the_benchmark_names_exists():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        assert (REPO / spec.TRAFFIC_DIR / f"{w['traffic']}.json").is_file()
    for m in bench["per_layer"]:
        assert (spec.METRICS_DIR / f"{m['name']}.py").is_file()
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert (REPO / "port_bench" / "reference" / f"{cfg['reference']}.py").is_file()
        assert (REPO / "port_bench" / "models" / f"{cfg['family']}.py").is_file()
    for w in bench["workloads"]:
        traffic = json.loads((REPO / spec.TRAFFIC_DIR / f"{w['traffic']}.json").read_text())
        assert (REPO / "port_bench" / "kinds" / f"{traffic['kind']}.py").is_file()
