"""The yardstick's bounds reproduce the kernel table's (PERF.md, section 6:
the bounds the repository's smoke run holds each kernel to)."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from hmbench import port
from hmbench.roofline import kernels as k
from hmbench.roofline import launchers
from hmbench.roofline import svmogp


def test_kernel_bounds_match_the_kernel_table():
    assert k.right(4, 3072, 1024, "product")[0] == pytest.approx(0.1925, abs=5e-5)
    assert k.proj(4, 3072, 1024, passes=1)[0] == pytest.approx(0.1925, abs=5e-5)
    assert k.proj(4, 3072, 1024, passes=3)[0] == pytest.approx(0.0391, abs=5e-5)
    assert k.proj(4, 768, 1024, passes=1)[0] == pytest.approx(0.0481, abs=5e-5)
    assert k.right(4, 65536, 1024, "product")[0] == pytest.approx(4.1067, abs=5e-4)
    assert k.right(4, 1024, 1024, passes=3)[0] == pytest.approx(0.0150, abs=5e-5)
    assert k.out(4, 768, 1024, passes=3)[0] == pytest.approx(0.0125, abs=5e-5)
    assert k.chol_panel(4, 128)[0] == pytest.approx(0.000196, abs=5e-7)
    assert k.rbf(4, 3072, 1024, 2)[0] == pytest.approx(0.0150, abs=5e-5)
    assert k.rbf(4, 65536, 1024, 2)[0] == pytest.approx(0.3207, abs=5e-4)
    # adam: 4,198,400 of the flagship's 4,206,672 elements free in a VE step,
    # 8,236 in a VM step
    assert k.adam(4_198_400, 8_272)[0] == pytest.approx(0.0351, abs=5e-5)
    assert k.adam(8_236, 4_198_436)[0] == pytest.approx(0.0201, abs=5e-5)


def _records(kind_launches):
    return [dict(launcher=n, args=list(a), kwargs=kw, capturing=True, launches=c)
            for n, a, kw, c in kind_launches]


S = port.Shape
VE_STEP = [  # a "high" VE step of the flagship, as its capture records it
    ("rbf_K_batched_vec", (S((3072, 2)), S((4, 1024, 2)), S((4,)), S((4,))), {}, 1),
    ("tril_projection_3pass_tma", (S((4, 3072, 1024)), S((4, 1024, 1024))), {}, 1),
    ("tril_right_tma", (S((4, 3072, 1024)), S((4, 1024, 1024)), "both"), {}, 1),
    ("tril_out3_tma", (S((4, 3072, 1024)), S((4, 3072, 1024))), {}, 1),
    ("task_var_exp", ([[2, S((512, 1)), S((512, 2)), S((512, 2)), S((512,)), None, None]]
                      * 6, [S(())] * 6), {}, 1),
    ("task_var_exp_backward", ([S((512, 4))] * 6, [S((512,))] * 6, [S(())] * 6, S((6,))),
     {}, 1),
    ("adam_update", ([S((4, 1024, 2)), S((4, 1024, 1)), S((4, 1024, 1024))],
                     [None, S((4, 1024, 1)), S((4, 1024, 1024))], [], [], S(()), 0.005),
     {}, 1),
]


def test_the_step_tables_have_the_launches_the_graphs_hold():
    records = _records(VE_STEP) + _records([("chol_panel", (S((4, 128, 128)),), {}, 8)])
    capture = {"ve": {n: c for n, _, _, c in VE_STEP}, "vm": {"chol_panel": 8}}
    graphs, why = launchers.graph_tables(records, ["ve", "vm"], capture)
    assert why == ""
    count = {}
    for _, sym, calls in graphs["ve"]:
        count[sym] = count.get(sym, 0) + calls
    assert count == {"rbf_cross_vec_kernel": 1, "tril_proj3_tma_kernel": 1,
                     "tril_split_bf16_kernel": 1, "tril_right_tma_kernel": 1,
                     "row_sum_kernel": 1, "tril_out3_tma_kernel": 1,
                     "ve_tasks_kernel": 1, "ve_tasks_grad_kernel": 1, "adam_kernel": 1}
    least = {sym: ms for ms, sym, _ in graphs["ve"]}
    assert least["tril_proj3_tma_kernel"] == pytest.approx(0.0391, abs=5e-5)
    assert least["tril_right_tma_kernel"] == pytest.approx(0.1925, abs=5e-5)
    assert least["adam_kernel"] == pytest.approx(k.adam(4_198_400, 8_192)[0])
    assert graphs["vm"] == [(k.chol_panel(4, 128)[0], "chol_panel_kernel", 8)]
    # a graph whose recorded launches are not the program's counters has no table
    capture["vm"]["chol_panel"] = 7
    graphs, why = launchers.graph_tables(records, ["ve", "vm"], capture)
    assert graphs is None and "vm" in why
    # every launcher the program counts has a bound
    from hetmogp_tpu_torch.ops import cuda_kernels
    assert set(cuda_kernels.launch_counts()) - {"rbf_backward"} <= set(launchers.FORMULAS)


def test_a_steps_products_lie_below_what_a_step_takes_at_the_peaks():
    cfg = json.loads((ROOT / "hmbench/configs/lmc6_m1024.json").read_text())
    least = svmogp.step_products(cfg)
    assert 0.25 < least["ve"] < 0.35 and 0.2 < least["vm"] < 0.3


def test_the_recorder_sees_each_launch_and_keeps_the_counters(monkeypatch):
    from hetmogp_tpu_torch.ops import cuda_kernels

    def fake(A, L):
        cuda_kernels.tril_projection_tma.launches += 1  # as the launchers count
        return A

    fake.launches = 0
    monkeypatch.setattr(cuda_kernels, "tril_projection_tma", fake)
    with port.record_launches() as log:
        import torch
        cuda_kernels.tril_projection_tma(torch.zeros(2, 5, 4), torch.zeros(2, 4, 4))
    assert cuda_kernels.tril_projection_tma is fake and fake.launches == 1
    assert log == [dict(launcher="tril_projection_tma", args=[(2, 5, 4), (2, 4, 4)],
                        kwargs={}, capturing=False, launches=1)]
