"""Config reading. Counterpart of ``imcui_tpu/utils/io.py::read_yaml``; the
HDF5 helpers of that module come with the pipelines' ``main()``s."""


def read_yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
