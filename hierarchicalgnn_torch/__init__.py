"""HierarchicalGNN on PyTorch and CUDA: the port of ``hierarchicalgnn_tpu``.

A second package beside the JAX one, with the same module layout, written
for one NVIDIA H100.  It imports ``torch`` and never JAX or the JAX
package.  Its hot reductions are CUDA kernels written for Hopper
(``csrc/``), built with nvcc at first use; on the CPU each kernel's plain
PyTorch version runs instead.  This slice ports the BC-HGNN-GMM serving
forward (``inference.InferenceEngine``).
"""

__version__ = "0.1.0"
