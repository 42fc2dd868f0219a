"""The control, at a size a test run holds: the cell's own run comes out
correct, and the same run with the port in the precision next below the
configuration's (``control.LOWER``) comes out not correct."""

import pytest

from benchmark import control, harness

SMALL = {
    "urand19-pagerank": ({"scale": 10},
                         {"sample_from_first": 2, "check_ranks": 2,
                          "warm_solves": 1}),
    "hpcg256-cg": ({"nx": 32, "ny": 32, "nz": 32},
                   {"sample_from_first": 2, "check_solves": 2,
                    "warm_solves": 1}),
}


def small_run(workload, device, value_type=None, seed=2 ** 32 + 3):
    config, mix = SMALL[workload]
    return harness.run_cell(workload, seed, 0.3, False, device=device,
                            port_value_type=value_type,
                            config_override=config, mix_override=mix)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_run_is_correct_and_control_is_not(workload):
    ok = small_run(workload, "cpu")
    assert ok["correct"], ok["checks"]
    low = small_run(workload, "cpu", control.lower_of(workload))
    assert not low["correct"], low["checks"]
    # the control fails a number that sound runs pass
    failed = [k for k, c in low["checks"].items() if c["value"] > c["limit"]]
    assert failed and all(ok["checks"][k]["value"] <= ok["checks"][k][
        "limit"] for k in failed)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_run_is_correct_and_control_is_not_on_the_card(workload, card):
    ok = small_run(workload, card)
    assert ok["correct"], ok["checks"]
    assert ok["device"]["platform"] == "gpu"
    low = small_run(workload, card, control.lower_of(workload))
    assert not low["correct"], low["checks"]


def test_one_tune_refuses_a_matrix_drawn_from_the_seed():
    with pytest.raises(SystemExit):
        next(control.one_tune_readings("urand19-pagerank", [1], None))


def test_lower_precision_is_the_next_below():
    assert control.lower_of("urand19-pagerank") == "bfloat16"
    assert control.lower_of("hpcg256-cg") == "float32"
