from gdrnet_tpu_torch.engine.tester import build_test_items, do_test

__all__ = ["build_test_items", "do_test"]
