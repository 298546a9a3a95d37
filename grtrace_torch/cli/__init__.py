"""Command-line drivers of the port (application context: the library
core never imports them): `main` (the full pipeline, with the disk
mode), `reshade`, `hotspot`, `subring`, `visibility`, `shadow`,
`magnify`, `echo`, `exact`, `images`, the line-profile fit's `line_grid`
and `fit_line`, the camera orbit `orbit`, `qpo`, `single_ray`,
`band_sweep`, `probe` and the throughput benchmark `bench_cli`.
They run on the CUDA card unless given --device cpu.  Unlike the JAX
package's drivers they have no compilation cache to enable: the CUDA
kernels build at first use into `build/`."""
