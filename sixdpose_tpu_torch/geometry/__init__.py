"""Geometry: rigid transforms, view-sphere sampling and the triangle
rasterizer (port of the JAX package's ``geometry``)."""
