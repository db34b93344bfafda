from viquae_torch.cli import main

main()
