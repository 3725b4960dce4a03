"""march_evals.<kind>: the tree evaluations a ray of the window's frames
took (its march steps and the 5 of its shading), from the program's
counter of the march (`gsdf_tpu_torch.eval.ray_kernels.MARCH`: frames,
rays, evaluations). The view kind's `count_work` takes every frame of the
traced window again after the window through a call that returns
evaluations, and the counter sums those. Nothing where the program has no
such counter, where it counted no ray, or where it counted frames other
than the window's."""
import importlib


def read(run, qualifier):
    try:
        march = importlib.import_module("gsdf_tpu_torch.eval.ray_kernels").MARCH
    except (ImportError, AttributeError):
        return None
    if not march.get("rays") or march.get("frames") != run.completed:
        return None
    return march["evaluations"] / march["rays"]
