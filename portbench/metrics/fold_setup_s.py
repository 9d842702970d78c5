"""The protocol's set-up: ``build_pool``, the fold lists, the model and
``FoldSetup.build`` with its trainer, on the host clock around the calls
(``drive.build``)."""


def read(run):
    return run.spans["fold_setup"]
