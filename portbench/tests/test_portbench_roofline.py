"""The operation, byte and FLOP counts at small shapes, by hand."""

import pytest

from portbench import roofline

MODEL = dict(num_classes=1, channels=2, k=4, fp_k=2, attention_knn=False)


def test_search_counts_every_pair():
    o = roofline.search(pairs=6, rows=2, cols=3, k=4)
    assert o["ops"] == 48 and o["bytes"] == 13 * 5 + 8 * 4 * 2
    assert roofline.bound_s(o) == max(48 / 33.5e12, o["bytes"] / 3.35e12)


def test_forward_ops_one_sample():
    counts = {"n": [8], "s1": [4], "s2": [2], "s3": [1]}
    ops = roofline.forward_ops(counts, MODEL, training=False)
    pairs = [o["ops"] / 8 for o in ops if o["op"] == "search"]
    # SA1-SA3 (centres x points), then FP3, FP2, FP1 (points x centres)
    assert pairs == [32, 8, 2, 2, 8, 32]
    assert [o["op"] for o in ops].count("blend") == 3
    assert not [o for o in ops if o["op"] == "blend_bwd"]
    assert len(roofline.forward_ops(counts, MODEL, True)) == len(ops) + 3


def test_attention_search_dims():
    counts = {"n": [8], "s1": [4], "s2": [2], "s3": [1]}
    ops = roofline.forward_ops(counts, dict(MODEL, attention_knn=True), False)
    dims = [o["ops"] / 2 / p for o, p in zip(
        [o for o in ops if o["op"] == "search_dim"], (8, 2))]
    c = MODEL["channels"]
    assert dims == [3 + 2 * ((4 * c + 4) // 2) + 4 * c,
                    3 + 2 * ((8 * c + 4) // 2) + 8 * c]


def test_net_macs_hand_count():
    c, k = 1, 1
    m = dict(MODEL, channels=c, k=k)
    # n = 1 point, one centre at every stage
    want = (3 * c + 3 * c                                  # stems
            + (c + 4) * 2 * c + 2 * c * 4 * c + 2 * 4 * c * 16 * c
            + 2 * 16 * c * 16 * c
            + (4 * c + 4) * 6 * c + 6 * c * 8 * c + 2 * 8 * c * 32 * c
            + 2 * 32 * c * 32 * c
            + (8 * c + 4) * 12 * c + 12 * c * 16 * c + 2 * 16 * c * 64 * c
            + 2 * 64 * c * 64 * c
            + (16 * c + 3) * 16 * c + 16 * c * 16 * c
            + 32 * c * 24 * c + 24 * c * 16 * c
            + 24 * c * 20 * c + 20 * c * 16 * c
            + 20 * c * 16 * c + 16 * c * 16 * c
            + 17 * c * 16 * c + 16 * c * 16 * c
            + 16 * c * 16 * c + 16 * c)
    assert roofline.net_macs(1, 1, 1, 1, m) == want
    counts = {"n": [1], "s1": [1], "s2": [1], "s3": [1]}
    assert roofline.net_flops(counts, m, True) == 6 * want


def test_share_by_kernel_name():
    ops = [roofline.search(1e12, 1e6, 1e6, 32)]
    share = roofline.roofline_share(ops, {"knn_topk_kernel<32>": 1.0,
                                          "elementwise": 5.0})
    assert share == pytest.approx(100 * 8e12 / 33.5e12)
    assert roofline.roofline_share(ops, {"elementwise": 1.0}) is None



def test_operation_span_times_the_whole_call():
    """The two-stage search's top-k bears no kernel name of the list; its
    span times the call whole, and the share counts that time."""
    import time

    from portbench import trace

    assert "group_min_kernel" not in roofline.KERNELS["search"]
    tracer = trace.Tracer(True)
    with tracer.operation("search"):
        pass  # inactive outside the traced window: nothing timed
    tracer.active = True
    with tracer.operation("search"):
        time.sleep(0.02)
    with tracer.operation("search"):
        time.sleep(0.01)
    spent = tracer.op_seconds()["search"]
    assert len(tracer.ops) == 2 and 0.03 <= spent < 1.0
    ops = [roofline.search(1e9, 1e3, 1e3, 2)]
    kernel_s = {"knn_top2_kernel": 0.01, "elementwise": 5.0}
    assert roofline.roofline_share(ops, kernel_s, {"search": spent}) == (
        pytest.approx(100 * roofline.bound_s(ops[0]) / (spent + 0.01)))
