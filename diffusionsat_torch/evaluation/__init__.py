from diffusionsat_torch.evaluation.harness import (
    evaluate_batch_generalization,
    evaluate_classic_solver,
    evaluate_round_generalization,
    evaluate_variable_generalization,
    make_cactus,
    test_invariance,
)
