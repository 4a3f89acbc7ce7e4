from rt.render.renderer import (ProgressiveRenderer, RenderState,  # noqa: F401
                                init_state, render_color, render_frame,
                                render_frames)
from rt.render.ppm import (compare_ppm, parity_metrics,  # noqa: F401
                           parse_ppm, render_ppm, write_ppm)
from rt.render.checkpoint import (load_pytree, load_render_state,  # noqa: F401
                                  save_pytree, save_render_state)
