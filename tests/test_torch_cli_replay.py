"""``python -m pathway_tpu_torch spawn --record``, ``replay`` and
``spawn --torch-distributed``.

A 2-worker cluster records its connectors' input, then ``replay`` re-runs
the program against the recording alone and writes the same net output.
``--torch-distributed`` is the port's counterpart of the JAX package's
``--jax-distributed``: the workers of the mesh also join one
``torch.distributed`` world (gloo on the CPU), rank = worker id.
"""

from __future__ import annotations

import json

from tests import torch_cluster_programs as progs
from tests.test_torch_cli_spawn import spawn


def test_record_then_replay_reproduces_the_run(tmp_path, monkeypatch, capfd):
    (tmp_path / "pin").mkdir()
    (tmp_path / "pin" / "a.csv").write_text("word\nfoo\nbar\nfoo\n")
    code, err, out = spawn(monkeypatch, capfd, tmp_path, "persisted_wordcount", "-n", "2", "--record",
                           "--record-path", str(tmp_path / "rec"))
    assert code == 0, err[-3000:]
    recorded = progs.canonical_bytes(tmp_path, "out.jsonl")
    assert {json.loads(k)["word"]: json.loads(k)["n"] for k, _ in json.loads(recorded)} == {
        "foo": 2, "bar": 1,
    }
    for name in ("out.jsonl", "out.jsonl.part-1"):
        (tmp_path / name).unlink(missing_ok=True)
    (tmp_path / "pin" / "a.csv").unlink()  # replay reads the recording, not the files
    code, err, out = spawn(monkeypatch, capfd, tmp_path, "persisted_wordcount", "-n", "2",
                           "--record-path", str(tmp_path / "rec"), command="replay")
    assert code == 0, err[-3000:]
    assert progs.canonical_bytes(tmp_path, "out.jsonl") == recorded


def test_torch_distributed_joins_the_workers_in_one_gloo_world(tmp_path, monkeypatch, capfd):
    script = tmp_path / "prog.py"
    script.write_text(
        "import json, os, torch, torch.distributed as dist\n"
        "import pathway_tpu_torch as pw\n"
        "from pathway_tpu_torch.io._utils import make_static_input_table\n"
        "t = make_static_input_table(pw.schema_from_types(v=int), [{'v': 1}, {'v': 2}])\n"
        "pw.io.jsonlines.write(t, os.path.join(os.path.dirname(__file__), 'out.jsonl'))\n"
        "pw.run()\n"
        "x = torch.tensor([float(dist.get_rank() + 1)])\n"
        "dist.all_reduce(x)\n"
        "print(json.dumps([dist.get_world_size(), dist.get_rank(), x.item()]))\n"
        "dist.destroy_process_group()\n"
    )
    code, err, out = spawn(monkeypatch, capfd, tmp_path, None, "-n", "2", "--torch-distributed",
                           script=str(script))
    assert code == 0, err[-3000:]
    seen = sorted(json.loads(line) for line in out.splitlines() if line.startswith("["))
    assert seen == [[2, 0, 3.0], [2, 1, 3.0]], out
    net = json.loads(progs.canonical_bytes(tmp_path, "out.jsonl"))
    assert sorted(json.loads(k)["v"] for k, _ in net) == [1, 2]
