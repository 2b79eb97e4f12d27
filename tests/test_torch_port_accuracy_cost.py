"""tools/accuracy_cost.py at a tiny width on the CPU: one epoch of training on
synthetic files, the same weights evaluated under the two protocols, and a
report in the root tool's keys (its numbers at this size mean nothing)."""

import json

from unav_yolyolva_tpu_torch.tools import accuracy_cost
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)


def test_accuracy_cost_reports_both_protocols(tmp_path, capsys):
    out = tmp_path / "cost.json"
    report = accuracy_cost.main(["--device", "cpu", "--tiny", "--epochs", "1", "--videos", "8",
                                 "--train-batch", "2", "--eval-batch", "4",
                                 "--root", str(tmp_path / "data"), "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert json.loads(out.read_text()) == report
    assert report["train_epochs"] == 1 and report["videos"] == 8 and report["seed"] == 0
    assert report["use_ema"] is False and report["device"] == "cpu"
    maps = report["avg_mAP"]
    assert set(maps) == {"fp32_exact", "bf16_exact"} == set(report["delta_vs_fp32_exact"])
    assert all(0.0 <= v <= 1.0 for v in maps.values())
    for name, delta in report["delta_vs_fp32_exact"].items():
        assert delta == maps[name] - maps["fp32_exact"]
    # on the CPU every wrapper runs its plain version: no kernel launches
    assert set(report["launches"]) == set(maps)
    assert not any(n for counts in report["launches"].values() for n in counts.values())
