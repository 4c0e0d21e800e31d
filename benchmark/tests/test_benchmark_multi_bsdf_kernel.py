"""The cell ``multi_bsdf.render`` against a fault planted in the lobe
container's CUDA kernel (csrc/bsdf.cu), which the card's no-grad forward
runs in place of the eager lobe code: a build of the kernel with the sheen
lobe evaluated and sampled as a diffuse one (its value 1/pi; its pdf and
its directions are the diffuse lobe's already) is loaded in place of the
real one, and the cell run at its own size must read ``correct`` false.
The fault of ``test_benchmark_multi_bsdf.py`` patches the eager lobe
tables, which the card's forward no longer reads. The source edit is
checked without a card; the run needs one."""
import pytest

import run

CELL = "multi_bsdf.render"
SHEEN_CALL = "sheen_f(p0, li, lo)"  # the sheen lobe's value in eval_slot and sample_slot
DIFFUSE_VALUE = "INV_PI_F"


def _sheen_as_diffuse_source() -> str:
    from phosphorus_mk2_tpu_torch.accel.build import CSRC

    source = (CSRC / "bsdf.cu").read_text()
    assert source.count(SHEEN_CALL) == 2, "the sheen lobe's calls in csrc/bsdf.cu moved"
    return source.replace(SHEEN_CALL, DIFFUSE_VALUE)


def test_the_faulted_source_replaces_both_sheen_values():
    faulted = _sheen_as_diffuse_source()
    assert SHEEN_CALL not in faulted
    assert "__device__ float sheen_f(" in faulted  # only the calls went


@pytest.mark.card
def test_sheen_as_diffuse_in_the_kernel_is_not_correct_at_the_cells_size(
        card, monkeypatch, tmp_path):
    from phosphorus_mk2_tpu_torch.accel.build import NVCC_FLAGS, find_nvcc, load_shared
    from phosphorus_mk2_tpu_torch.bsdf import kernel

    src = tmp_path / "bsdf.cu"
    src.write_text(_sheen_as_diffuse_source())
    lib, _ = load_shared(src, find_nvcc(), NVCC_FLAGS, "bsdf_sheen_as_diffuse")
    monkeypatch.setattr(kernel, "_lib", kernel.bind(lib))
    for seed in (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503):
        n0 = kernel.LAUNCHES["bsdf_eval"]
        # a window longer than a pass (5-7 s): the render is cancelled only between chunks
        args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "10"])
        res = run.execute(args)
        print("kernel fault", CELL, "sheen_as_diffuse", seed, res["checked"],
              res["films_checked"], flush=True)
        assert kernel.LAUNCHES["bsdf_eval"] > n0, "the run did not take the kernel route"
        assert not res["correct"]
