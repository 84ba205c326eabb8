"""Operations and bytes from shapes: hand counts at the flagship's shapes,
and the bounds of PERF.md's kernel table (ids uniform over 1e5 rows a
slot, B = 16,384, m = 26, D = 16, d1 = 17, bf16 rows and grads)."""

import pytest

from benchmark import counts

B, M, D, H = 16384, 26, 16, (128, 128)
CARD = "NVIDIA H100 80GB HBM3"
UNIQUE_1E5 = counts.expected_unique_uniform(B, M, 100_000)


def test_cin_forward_by_hand():
    layer1 = 2 * B * D * 128 * M * M  # X1 = W1 (X0 * X0)
    pooled = 2 * B * 128 * M * D  # t = sum_d X1 X0
    layer2 = 2 * B * 128 * (M * 128)  # t W2
    assert counts.cin_forward_flops(B, M, D, H) == layer1 + pooled + layer2 == 61_069_066_240


def test_cin_backward_by_hand():
    layer1 = 2 * (2 * B * D * 128 * M * M) + 2 * (2 * B * M * M * D)
    layer2 = 2 * (2 * B * 128 * M * D) + 2 * (2 * B * 128 * M * 128)
    assert counts.cin_backward_flops(B, M, D, H) == layer1 + layer2


def test_gather_and_update_bytes_by_hand():
    u, n = 1000, 4096
    assert counts.gather_bytes(u, n, 17) == u * 17 * 4 + n * 4 + n * 17 * 2
    assert counts.adagrad_update_bytes(u, n, 17) == u * 17 * 16 + n * 17 * 2 + n * 4


@pytest.mark.parametrize("name, ms", [("gather", 0.0128), ("cin_fwd", 0.0617), ("update", 0.0367),
                                      ("cin_bwd", 0.1242)])
def test_the_bounds_of_the_kernel_table(name, ms):
    n = B * M
    bound = {
        "gather": lambda: counts.bound_ms(CARD, nbytes=counts.gather_bytes(UNIQUE_1E5, n, 17)),
        "cin_fwd": lambda: counts.bound_ms(CARD, flops=counts.cin_forward_flops(B, M, D, H)),
        "update": lambda: counts.bound_ms(CARD, nbytes=counts.adagrad_update_bytes(UNIQUE_1E5, n, 17)),
        "cin_bwd": lambda: counts.bound_ms(CARD, flops=counts.cin_backward_flops(B, M, D, H)),
    }[name]()
    assert round(bound, 4) == ms


def test_whole_step_operations():
    x = {"model": "xdeepfm", "n_slots": M, "embed_dim": D, "n_dense": 13, "cin_sizes": list(H), "hidden": [400, 400]}
    d = {"model": "deepfm", "n_slots": M, "embed_dim": D, "n_dense": 13, "hidden": [400, 400, 400]}
    mlp_x = 2 * (429 * 400 + 400 * 400 + 400 * 1)
    assert counts.mlp_forward_flops(1, 429, [400, 400]) == mlp_x
    step_x = counts.step_flops(x, B)
    assert 216e9 < step_x < 218e9  # about 13.2 MFLOP an example
    assert 2.9e6 < counts.step_flops(d, 1) < 3.0e6
    assert counts.step_flops(x, 1, train=False) < counts.step_flops(x, 1) / 2.5


def test_a_card_not_in_the_table_has_no_bound():
    assert counts.bound_ms("some other card", flops=1e9) is None
    assert counts.peak(CARD, "bf16_flops_per_s") == 989e12
