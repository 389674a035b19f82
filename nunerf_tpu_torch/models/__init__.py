from nunerf_tpu_torch.models.stage1 import ShapeRenderer
from nunerf_tpu_torch.models.stage2 import Stage2Renderer
from nunerf_tpu_torch.models.stage2_shell import Stage2ShellRenderer


def build_renderer(cfg, **kwargs):
    """The renderer a config names; counterpart of
    ``nunerf_tpu/models/__init__.py`` (reference ``name2renderer``,
    renderer.py:2400-2403, with the thickness-mode selection of
    run_training.py:16-20).  ``kwargs`` (``device``, ``seed``, ...) go to
    the renderer."""
    network = cfg.get("network", "shape")
    if network == "shape":
        return ShapeRenderer(cfg, **kwargs)
    if network == "stage2":
        if cfg.get("zero_thickness", False):
            return Stage2Renderer(cfg, **kwargs)
        return Stage2ShellRenderer(cfg, **kwargs)
    raise NotImplementedError(network)


name2renderer = {
    "shape": ShapeRenderer,
    "stage2": Stage2Renderer,
}
