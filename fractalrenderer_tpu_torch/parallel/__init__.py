"""Row bands across devices and progressive tiled rendering."""
from .mesh import RenderMesh, make_render_mesh
from .tiled import render_frames_sharded, render_giant_still, render_sharded
