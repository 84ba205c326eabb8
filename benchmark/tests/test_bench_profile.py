"""The device trace's layers: the program's own kernels by the harness's
map, a kernel of the program's that the map does not name shown as
``unmapped`` (in its layer and in the breakdown), and the CIN forward's
roofline read only where its time can be read apart."""

from pathlib import Path

from benchmark import harness, profile

from conftest import ROOT

FWD = "void rm::(anonymous namespace)::cin_layer_bf16_kernel<4, 2>(CUtensorMap, CUtensorMap, int)"
RELAYOUT = "void rm::(anonymous namespace)::permute_kernel(rm::Perms)"
FUSED = "void rm::(anonymous namespace)::gemm_tn_kernel(CUtensorMap, CUtensorMap)"
BWD = "void rm::(anonymous namespace)::cin_bwd_rows_kernel(CUtensorMap)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)"


def test_the_programs_kernels_are_read_from_its_sources():
    names = profile.program_kernels()
    assert {"cin_layer_bf16_kernel", "sorted_update_kernel", "gather_tiles_kernel", "permute_kernel"} <= names
    mapped = {n for names_ in profile.KERNEL_MAP["own"].values() for n in names_}
    assert names <= mapped  # every kernel the program has today is mapped


def test_layers_by_name(monkeypatch):
    assert profile.layer_of(FWD) == "cin_fwd" and profile.layer_of(RELAYOUT) == "cin_relayout"
    assert profile.layer_of("void sorted_update::(anonymous namespace)::sorted_update_kernel<Op>(Args)") == "emb_update"
    assert profile.layer_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "library"
    assert profile.layer_of("Memcpy DtoD (Device -> Device)") == "copy"
    assert profile.layer_of(GLUE) == "glue"
    renamed = "void rm::(anonymous namespace)::cin_layer_bf16_v2_kernel<4>(CUtensorMap)"
    assert profile.layer_of(renamed) == "glue"  # not a kernel of the program's sources
    monkeypatch.setattr(profile, "program_kernels", lambda: frozenset({"cin_layer_bf16_v2_kernel"}))
    assert profile.layer_of(renamed) == "unmapped"


def test_an_unmapped_kernel_shows_in_the_breakdown(monkeypatch):
    monkeypatch.setattr(profile, "program_kernels", lambda: frozenset({"new_kernel"}))
    t = profile.Trace(device_ops=[(GLUE, i * 100, 50) for i in range(11)] + [(f"void k{i}(int)", 2000 + i, 40)
                                                                           for i in range(12)]
                      + [("void rm::new_kernel(int)", 5000, 1)])
    top = t.top_ops()
    assert len(top) == 10 and top[0][0].startswith("glue: ")
    assert top[-1][0] == "unmapped: rm::new_kernel" and top[-1][1] == 1e-9
    assert t.layer_ms("unmapped") == 1e-6


def reader():
    return harness.load_module(Path(ROOT) / "benchmark/metrics/cin_fwd_roofline.py", "t_cin_fwd")


def roofline(ops):
    ctx = {"kind": "train", "batch_size": 16384, "card": "NVIDIA H100 80GB HBM3",
           "config": {"model": "xdeepfm", "n_slots": 26, "embed_dim": 16, "cin_sizes": [200, 200]},
           "trace": profile.Trace(device_ops=ops, steps=1)}
    return reader().read(ctx)


def test_the_cin_forward_roofline_reads_only_the_forward():
    alone = roofline([(FWD, 0, 1_000_000), (RELAYOUT, 0, 100_000), (GLUE, 0, 5_000_000)])
    from benchmark import counts
    bound = counts.bound_ms("NVIDIA H100 80GB HBM3", flops=counts.cin_forward_flops(16384, 26, 16, [200, 200]))
    assert abs(alone - 100 * bound / 1.1) < 1e-9 and 0 < alone < 100
    assert roofline([(FWD, 0, 1_000_000), (FUSED, 0, 10)]) is None
    assert roofline([(FWD, 0, 1_000_000), (RELAYOUT, 0, 10), (BWD, 0, 10)]) is None
    assert roofline([(GLUE, 0, 1_000_000)]) is None
