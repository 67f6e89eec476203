from fpr_tpu_torch.cli import main

main()
