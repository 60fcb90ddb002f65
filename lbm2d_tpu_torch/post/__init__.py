"""Dataset post-processing: HDF5 -> normalized Zarr (copies of the JAX
package's ``post/``, byte-equal output)."""
