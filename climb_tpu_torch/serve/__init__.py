from climb_tpu_torch.serve.export import ExportedModel, export_eval_step

__all__ = ["ExportedModel", "export_eval_step"]


def __getattr__(name):
    # lazy: importing the artifact reader does not load the HTTP server
    if name in ("create_server", "InferenceService", "RequestBatcher"):
        from climb_tpu_torch.serve import server

        return getattr(server, name)
    raise AttributeError(name)
