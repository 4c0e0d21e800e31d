"""Checkpoint/resume is not ported yet: the port must refuse it, never
render as if it were not asked for.

The JAX Renderer loads ``film_checkpoint.npz`` from
``Options.checkpoint_dir`` whenever the directory is set, whatever
``checkpoint_every`` says (phosphorus_mk2_tpu/renderer.py ``passes`` ->
``_load_checkpoint``), so a render given only the directory resumes
there. Until the port has that, a Renderer given a checkpoint directory
raises NotImplementedError.
"""
import pytest
import torch

from phosphorus_mk2_tpu_torch import scenes
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.renderer import Renderer

torch.set_num_threads(1)


@pytest.mark.parametrize("every", [0, 1, 3])
def test_a_checkpoint_dir_raises_whatever_checkpoint_every_says(tmp_path, every):
    with pytest.raises(NotImplementedError, match="checkpoint"):
        Renderer(scenes.cornell_box(8, 8),
                 Options(checkpoint_dir=str(tmp_path), checkpoint_every=every), device="cpu")


def test_checkpoint_every_without_a_dir_renders():
    """Without a directory there is nothing to resume from or save to: the
    JAX Renderer renders, and so does the port."""
    r = Renderer(scenes.cornell_box(8, 8),
                 Options(checkpoint_every=2, samples_per_pixel=1, path_depth=1,
                         use_bvh=False), device="cpu")
    assert r.render()["color"].shape == (8, 8, 3)
