"""Progressive rendering engine: accumulation state, renderer, image IO."""

from spt_tpu_torch.engine.state import RenderState, init_state, save_checkpoint, load_checkpoint
from spt_tpu_torch.engine.renderer import Renderer

__all__ = ["RenderState", "init_state", "save_checkpoint", "load_checkpoint", "Renderer"]
