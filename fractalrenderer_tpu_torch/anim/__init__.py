"""Animation subsystem of the port: keyframes, .franim IO, batched
rendering, video (the same names as ``fractalrenderer_tpu.anim``)."""
from .keyframes import Animation, InterpolationType, Keyframe, Playback
from .renderer import AnimationRenderer, RenderProgress, RenderStatus
from . import franim, video
