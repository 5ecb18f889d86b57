"""A configuration, a traffic mix and a per-layer metric are added as new
files and manifest entries only: a copy of the benchmark with a throwaway
cell of each runs, and no file the benchmark had is edited."""
import filecmp
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_new_files_add_a_cell(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns("_out", "__pycache__", "tests"))
    (pb / "configs" / "box.json").write_text(json.dumps(
        dict(json.loads((pb / "configs" / "cornell.json").read_text()), name="box",
             light_emit=[8.0, 8.0, 8.0])))
    shutil.copy(pb / "configs" / "cornell.py", pb / "configs" / "box.py")
    (pb / "traffic" / "tiny.json").write_text(json.dumps({
        "generator": "render", "res": 8, "spp": 1, "kind": "path", "max_depth": 2,
        "light_strategy": "one", "check_pixels": 16,
        "limits": {"rel_gap": 1e-4}}))
    (pb / "layers" / "requests_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.window.requests)\n")
    man = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    man["configs"].append({"name": "box", "source": "https://example.org/box",
                           "file": "portbench/configs/box.json", "reduced": [],
                           "why": "a throwaway configuration"})
    man["workloads"].append({"name": "box.tiny", "config": "box", "traffic": "tiny",
                             "chips": 1, "why": "a throwaway cell"})
    man["end_to_end"][0]["workloads"].append("box.tiny")
    man["per_layer"].append({"name": "requests_in_window", "unit": "requests",
                             "better": "higher", "source": "host_clock", "layer": "render loop",
                             "moves": "camera_rays_per_s", "workloads": ["box.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import json; from portbench import run; "
            "r, _ = run.execute('box.tiny', 7, 0.1, 1, 'cpu'); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["requests_in_window"]["value"] >= 1
    for sub in ("configs", "traffic", "layers", "generators", "reference"):
        cmp = filecmp.dircmp(os.path.join(HERE, sub), pb / sub, ignore=["__pycache__"])
        assert not cmp.diff_files and not cmp.left_only, sub


def test_no_card_no_result(tmp_path):
    """Without a card the command exits with another code than 0 and prints
    no result; so it does in a directory holding only the benchmark."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for cwd, path in ((ROOT, ROOT), (tmp_path, str(tmp_path))):
        env = dict(os.environ, PYTHONPATH=path, CUDA_VISIBLE_DEVICES="")
        out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                              "cornell.path", "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and not out.stdout.strip()
