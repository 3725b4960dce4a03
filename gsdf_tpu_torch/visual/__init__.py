"""Visualisation of 3D trees: the raymarcher (visual/raymarch.py), a
shaded image or an orbit of a part on the card (torch counterpart of
gsdf_tpu/visual/raymarch.py). The GLSL and shadertoy export of the JAX
package's visual/ are not ported yet."""
