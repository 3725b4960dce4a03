// K8's counting form: raymarch.cu around the tree's baked source, with
// each short-circuit site of the tree's code counted (raymarch.cu's note
// on GSDF_RM_COUNT_SITES). Built per tree that has sites or polygons, as a
// library of its own, behind `eval/ray_kernels.py::count_short_circuits`:
// the image and the evaluation counts are K8's, from the same generated
// code. A site is a Difference's skipped subtrahend or a union's skipped
// member (codegen/cuda.py): both count alike; a threshold form's bin-table
// loop counts the members it walks; a polygon's edge loop the edges that
// divide.
#define GSDF_RM_COUNT_SITES 1
#include "raymarch.cu"
