"""Examples of the port, the counterparts of the reference's examples/ (run
each as a module from the repository's root, e.g.
`python -m temporalgps_torch.examples.exact_time_inference`)."""
